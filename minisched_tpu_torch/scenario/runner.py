"""Scenario runner: the README scenario on the port's live engines.

Counterpart of ``minisched_tpu/scenario/runner.py``: ``ScenarioHarness``
boots a control plane and the scheduler service (without the JAX
package's PV controller, which no scenario here needs), and
``readme_scenario`` drives the reference's integration scenario with
condition-based waits: nine cordoned nodes keep ``pod1`` pending, then
``node10`` appears and ``pod1`` binds there.  ``readme_scenario_http``
drives it over a running process's REST façade.

Run it on the device engine on the card (or ``--device cpu`` on the
host), or on the scalar engine, the JAX runner's default, which is host
only (``--scalar``)::

    python -m minisched_tpu_torch.scenario.runner [--scalar]
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Optional

from minisched_tpu_torch.api.objects import make_node, make_pod
from minisched_tpu_torch.controlplane.client import Client
from minisched_tpu_torch.service.config import (
    SchedulerConfig,
    default_scheduler_config,
)
from minisched_tpu_torch.service.service import SchedulerService


class ScenarioTimeout(AssertionError):
    pass


class ScenarioHarness:
    """A client, its store and the scheduler service: the device engine on
    ``device`` (None: the card) with waves of ``max_wave``, or with
    ``device_mode=False`` the scalar engine."""

    def __init__(self, cfg: Optional[SchedulerConfig] = None,
                 device: Any = None, max_wave: int = 64,
                 device_mode: bool = True):
        self.client = Client()
        self.service = SchedulerService(self.client)
        self.cfg = cfg or default_scheduler_config()
        self.device = device
        self.max_wave = max_wave
        self.device_mode = device_mode

    def __enter__(self) -> "ScenarioHarness":
        self.service.start_scheduler(self.cfg, device_mode=self.device_mode,
                                     max_wave=self.max_wave,
                                     device=self.device)
        return self

    def __exit__(self, *exc) -> None:
        self.service.close()

    def wait_for(self, pred: Callable[[], bool], timeout: float = 10.0,
                 interval: float = 0.01, msg: str = "condition") -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if pred():
                return
            time.sleep(interval)
        if pred():
            return
        raise ScenarioTimeout(f"timed out waiting for {msg}")

    def pod_node(self, name: str, namespace: str = "default") -> str:
        return self.client.pods().get(name, namespace).spec.node_name


def readme_scenario(harness: ScenarioHarness,
                    log: Callable[[str], None] = print) -> str:
    """The reference's integration scenario (sched.go:70-143):

    1. create nodes node0..node8, all unschedulable, and pod1 — the pod
       must stay pending, parked in the unschedulableQ;
    2. create schedulable node10 — the Node/Add event requeues pod1 and it
       binds to node10.

    Returns the bound node name."""
    client = harness.client
    for i in range(9):
        client.nodes().create(make_node(f"node{i}", unschedulable=True))
    log("created 9 unschedulable nodes")
    client.pods().create(make_pod("pod1"))
    log("created pod1")
    harness.wait_for(
        lambda: harness.service.scheduler.queue.stats()["unschedulable"] == 1,
        msg="pod1 parked in unschedulableQ")
    if harness.pod_node("pod1"):
        raise AssertionError("pod1 should not be bound yet")
    log("pod1 is pending (no feasible node)")
    client.nodes().create(make_node("node10", unschedulable=False))
    log("created schedulable node10")
    harness.wait_for(lambda: harness.pod_node("pod1") == "node10",
                     timeout=15.0, msg="pod1 bound to node10")
    bound = harness.pod_node("pod1")
    log(f"pod1 is bound to {bound}")
    return bound


def readme_scenario_http(http: Any, timeout: float = 30.0,
                         log: Callable[[str], None] = print) -> str:
    """The same scenario against a running process, through its REST
    façade (``controlplane.httpserver.HTTPClient``): ``pod1`` counts as
    pending once its FailedScheduling event is listed.  Returns the bound
    node name."""

    def wait(pred: Callable[[], bool], msg: str) -> None:
        deadline = time.monotonic() + timeout
        while not pred():
            if time.monotonic() > deadline:
                raise ScenarioTimeout(f"timed out waiting for {msg}")
            time.sleep(0.02)

    def failed() -> bool:
        events = http._req("GET", "/api/v1/namespaces/default/events")
        return any(e["reason"] == "FailedScheduling"
                   and e["regarding"] == "default/pod1"
                   for e in events["items"])

    for i in range(9):
        http.nodes().create(make_node(f"node{i}", unschedulable=True))
    http.pods().create(make_pod("pod1"))
    wait(failed, "pod1's FailedScheduling event")
    if http.pods().get("pod1").spec.node_name:
        raise AssertionError("pod1 should not be bound yet")
    log("pod1 is pending (no feasible node)")
    http.nodes().create(make_node("node10", unschedulable=False))
    wait(lambda: http.pods().get("pod1").spec.node_name == "node10",
         "pod1 bound to node10")
    log("pod1 is bound to node10")
    return http.pods().get("pod1").spec.node_name


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the device engine (default: the "
                         "card)")
    ap.add_argument("--scalar", action="store_true",
                    help="run the scalar engine (host only)")
    args = ap.parse_args()
    # time_scale compresses NodeNumber's permit delay (node10's suffix 0
    # is a zero delay; the timeout is still armed)
    with ScenarioHarness(default_scheduler_config(time_scale=0.1),
                         device=args.device,
                         device_mode=not args.scalar) as h:
        bound = readme_scenario(h)
        errors = h.service.scheduler.loop_errors
    if bound != "node10" or errors:
        raise SystemExit(f"scenario FAILED: bound to {bound!r}, "
                         f"{errors} loop error(s)")
    print("scenario OK")


if __name__ == "__main__":
    main()
