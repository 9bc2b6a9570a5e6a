"""Core scheduling-framework types.

A copy of ``minisched_tpu/framework/types.py``: the re-creation of the types the reference imports from
``k8s.io/kubernetes/pkg/scheduler/framework`` (see SURVEY.md §2 tail):
``Status`` + codes (reference usage: minisched/minisched.go:90,215,
minisched/waitingpod/waitingpod.go:96,112), ``CycleState``
(minisched/minisched.go:37, nodenumber.go:46-61), ``NodeScore`` /
``NodeScoreList`` (minisched/minisched.go:164-199), ``FitError`` /
``Diagnosis`` (minisched/minisched.go:143-148,287-290), and
``QueuedPodInfo`` (minisched/queue/queue.go:156-164).

These are host-side control-plane types in plain Python; device-side
state lives in the tables of ``minisched_tpu_torch.models.tables``.
"""

from __future__ import annotations

import enum
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set

MAX_NODE_SCORE = 100


class Code(enum.IntEnum):
    """Status codes, mirroring the upstream scheduler framework's enum.

    The reference relies on Success / Error / Unschedulable /
    UnschedulableAndUnresolvable / Wait / Skip semantics (e.g. filter
    short-circuit at minisched/minisched.go:130-137 and the permit Wait
    protocol at minisched/minisched.go:201-237).
    """

    SUCCESS = 0
    ERROR = 1
    UNSCHEDULABLE = 2
    UNSCHEDULABLE_AND_UNRESOLVABLE = 3
    WAIT = 4
    SKIP = 5


class Status:
    """Result of running a plugin or an extension point.

    A ``None`` status is treated as Success, matching upstream convention
    (helpers accept ``Optional[Status]``).
    """

    __slots__ = ("code", "reasons", "err", "plugin")

    def __init__(
        self,
        code: Code = Code.SUCCESS,
        reasons: Optional[List[str]] = None,
        err: Optional[BaseException] = None,
        plugin: str = "",
    ):
        self.code = code
        self.reasons = list(reasons) if reasons else []
        self.err = err
        self.plugin = plugin

    # -- constructors ------------------------------------------------------
    @staticmethod
    def success() -> "Status":
        return Status(Code.SUCCESS)

    @staticmethod
    def error(msg: str) -> "Status":
        s = Status(Code.ERROR, [msg])
        s.err = RuntimeError(msg)
        return s

    @staticmethod
    def unschedulable(*reasons: str) -> "Status":
        return Status(Code.UNSCHEDULABLE, list(reasons))

    @staticmethod
    def unresolvable(*reasons: str) -> "Status":
        return Status(Code.UNSCHEDULABLE_AND_UNRESOLVABLE, list(reasons))

    @staticmethod
    def wait() -> "Status":
        return Status(Code.WAIT)

    @staticmethod
    def skip() -> "Status":
        return Status(Code.SKIP)

    @staticmethod
    def from_error(err: BaseException) -> "Status":
        s = Status(Code.ERROR, [str(err)])
        s.err = err
        return s

    # -- predicates --------------------------------------------------------
    def is_success(self) -> bool:
        return self.code == Code.SUCCESS

    def is_wait(self) -> bool:
        return self.code == Code.WAIT

    def is_skip(self) -> bool:
        return self.code == Code.SKIP

    def is_unschedulable(self) -> bool:
        return self.code in (
            Code.UNSCHEDULABLE,
            Code.UNSCHEDULABLE_AND_UNRESOLVABLE,
        )

    def with_plugin(self, name: str) -> "Status":
        self.plugin = name
        return self

    def message(self) -> str:
        return ", ".join(self.reasons)

    def as_error(self) -> Optional[BaseException]:
        """Error view of a non-success status.

        The reference has a known bug passing stale/nil errors to ErrorFunc
        (minisched/minisched.go:64,73,92) — we always derive the error from
        the status itself (SURVEY.md §7 "known bugs — do not copy").
        """
        if self.is_success():
            return None
        if self.err is not None:
            return self.err
        return RuntimeError(self.message() or self.code.name)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Status({self.code.name}, {self.reasons!r}, plugin={self.plugin!r})"


def status_code(status: Optional[Status]) -> Code:
    return Code.SUCCESS if status is None else status.code


def is_success(status: Optional[Status]) -> bool:
    return status is None or status.is_success()


class CycleState:
    """Per-scheduling-cycle scratch state shared between extension points.

    Mirrors framework.CycleState (used at minisched/minisched.go:37 and
    written/read by the nodenumber plugin, nodenumber.go:46-61): a
    thread-safe keyed store.
    """

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._storage: Dict[str, Any] = {}

    def read(self, key: str) -> Any:
        with self._lock:
            if key not in self._storage:
                raise KeyError(key)
            return self._storage[key]

    def write(self, key: str, value: Any) -> None:
        with self._lock:
            self._storage[key] = value

    def delete(self, key: str) -> None:
        with self._lock:
            self._storage.pop(key, None)


@dataclass
class NodeScore:
    """Score of one node from one plugin (framework.NodeScore)."""

    name: str
    score: int


NodeScoreList = List[NodeScore]


@dataclass
class Diagnosis:
    """Why a pod failed to schedule (framework.Diagnosis).

    ``node_to_status`` maps node name → failing Status;
    ``unschedulable_plugins`` feeds the event-gated requeue predicate
    (minisched/queue/queue.go:71-73,167-190).
    """

    node_to_status: Dict[str, Status] = field(default_factory=dict)
    unschedulable_plugins: Set[str] = field(default_factory=set)


class FitError(Exception):
    """No node fits the pod (framework.FitError, minisched.go:143-148)."""

    def __init__(self, pod: Any, num_all_nodes: int, diagnosis: Diagnosis):
        self.pod = pod
        self.num_all_nodes = num_all_nodes
        self.diagnosis = diagnosis
        super().__init__(self._message())

    def _message(self) -> str:
        reasons: Dict[str, int] = {}
        for status in self.diagnosis.node_to_status.values():
            for reason in status.reasons:
                reasons[reason] = reasons.get(reason, 0) + 1
        parts = [f"{count} {reason}" for reason, count in sorted(reasons.items())]
        detail = ", ".join(parts) or "no reasons given"
        return (
            f"0/{self.num_all_nodes} nodes are available: {detail}."
        )


@dataclass
class PodInfo:
    """Wrapper of a pod carried through the queue (framework.PodInfo)."""

    pod: Any

    @property
    def uid(self) -> str:
        return self.pod.metadata.uid


@dataclass
class QueuedPodInfo:
    """Queue bookkeeping around a pod (framework.QueuedPodInfo; reference
    constructs these at minisched/queue/queue.go:156-164 and in ErrorFunc,
    minisched/minisched.go:283-298)."""

    pod_info: PodInfo
    timestamp: float = field(default_factory=time.monotonic)
    attempts: int = 0
    initial_attempt_timestamp: float = field(default_factory=time.monotonic)
    unschedulable_plugins: Set[str] = field(default_factory=set)
    #: queue scheduling-cycle number stamped at pop time (upstream
    #: podSchedulingCycle): lets the queue detect a cluster move-request
    #: that fired DURING this pod's attempt and route the failure to the
    #: backoffQ instead of stranding it in the unschedulableQ
    scheduling_cycle: int = 0

    @property
    def pod(self) -> Any:
        return self.pod_info.pod

    @property
    def uid(self) -> str:
        return self.pod_info.uid
