"""The scan lanes' split of a lane call, on the CPU.

A lane call (``scan_evaluate``) opens ``scan_prepare`` (the lane's entry
up to the step loop), ``scan_capture`` (a card's warm-up step and graph
capture) and ``scan_replay`` (the replays, or the eager loop) through
the ``StepLog``'s ``timed`` hook, which the engine points at its
``CycleMetrics``; the lanes' ``LaneStats`` add the replays timed by CUDA
events and their seconds, and the two builds of ``scan_build``.  Here a
live port engine (no JAX) flushes a spread backlog through each lane,
and the step loops run with and without a hook.  ``lane_run`` is also
the card's test of the same split (``test_torch_cuda.py``).
"""

from __future__ import annotations

import contextlib
import threading
import time

import pytest
import torch

from minisched_tpu_torch.api import objects as tobj
from minisched_tpu_torch.controlplane.client import Client
from minisched_tpu_torch.observability.profiling import CycleMetrics
from minisched_tpu_torch.ops import kernels
from minisched_tpu_torch.ops import sequential as seq
from minisched_tpu_torch.parallel import sharding
from minisched_tpu_torch.service import config
from minisched_tpu_torch.service.service import SchedulerService

#: the spans a lane call opens inside ``scan_evaluate``
LANE_SPANS = ("scan_prepare", "scan_capture", "scan_replay")
#: spans whose self time ``scan.host_ms_per_pod`` reads: none of the
#: lane spans may be their direct child
HOST_SPANS = ("scan_build", "scan_flush", "scan_grouping")


class SpanLog(CycleMetrics):
    """A ``CycleMetrics`` that also keeps every timed phase as
    (phase, start, end, thread)."""

    def __init__(self):
        super().__init__()
        self.spans = []

    @contextlib.contextmanager
    def timed(self, phase):
        t0 = time.monotonic()
        try:
            yield
        finally:
            t1 = time.monotonic()
            self.observe(phase, t1 - t0)
            self.spans.append((phase, t0, t1, threading.get_ident()))


def parent(spans, span):
    """The phase of the innermost other span on ``span``'s thread that
    contains it, None when none does."""
    around = [s for s in spans if s is not span and s[3] == span[3]
              and s[1] <= span[1] and span[2] <= s[2]]
    if not around:
        return None
    return max(around, key=lambda s: (s[1], -s[2]))[0]


def _spread_pod(i, app):
    return tobj.make_pod(
        f"sp{i:03d}", labels={"app": app},
        requests={"cpu": "100m", "memory": "128Mi"},
        topology_spread_constraints=[tobj.TopologySpreadConstraint(
            max_skew=1, topology_key="zone",
            when_unsatisfiable="DoNotSchedule",
            label_selector=tobj.LabelSelector(match_labels={"app": app}))])


def lane_run(lane, device, monkeypatch):
    """A serial live engine on ``device`` over 16 nodes in 4 zones that
    flushes a backlog of spread pods into ``lane``: 24 pods (at most
    ``SCAN_BLOCK_SIZE``: the exact lane) or 96 (the blocked lane), every
    one bound.  Returns (spans, ``scan_stats``, the phase snapshot)."""
    monkeypatch.setenv("MINISCHED_PIPELINE", "0")
    n = 24 if lane == "exact" else 96
    client = Client()
    client.nodes().create_many([
        tobj.make_node(f"node{i:02d}", labels={"zone": f"z{i % 4}"},
                       capacity={"cpu": "8", "memory": "32Gi", "pods": 110})
        for i in range(16)])
    pods = [_spread_pod(i, f"app{i % 6}") for i in range(n)]
    for i, p in enumerate(pods):
        p.metadata.uid = f"pod-{i:08d}"
    client.pods().create_many(pods)
    metrics = SpanLog()
    svc = SchedulerService(client)
    try:
        sched = svc.start_scheduler(config.default_full_roster_config(),
                                    device_mode=True, max_wave=128,
                                    device=device, prewarm_scan=False,
                                    metrics=metrics)
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline and not all(
                p.spec.node_name for p in client.pods().list()):
            time.sleep(0.05)
        assert all(p.spec.node_name for p in client.pods().list())
        assert sched.loop_errors == 0
        stats = {k: v for k, v in sched.scan_stats.items()}
    finally:
        svc.close()
    assert stats[lane].calls >= 1
    assert sum(s.placed for s in stats.values()) == n
    return list(metrics.spans), stats, metrics.snapshot()


def assert_lane_split(spans, stats, phases):
    """What holds on every device: each lane span's direct parent is a
    ``scan_evaluate`` on its own thread (so none is a child of a span
    whose self time the host metric reads), one ``scan_prepare`` a lane
    call, and the two builds inside ``scan_build``'s total."""
    calls = sum(s.calls for s in stats.values())
    lane_spans = [s for s in spans if s[0] in LANE_SPANS]
    assert sum(s[0] == "scan_prepare" for s in spans) == calls
    assert sum(s[0] == "scan_replay" for s in spans) >= 1
    for span in lane_spans:
        assert parent(spans, span) == "scan_evaluate", span
    assert not [s for s in lane_spans if parent(spans, s) in HOST_SPANS]
    built = sum(s.build_tables_s + s.build_constraints_s
                for s in stats.values())
    assert 0 < built <= phases["scan_build"]["total_s"]
    assert all(s.build_tables_s > 0 for s in stats.values() if s.calls)


@pytest.mark.parametrize("lane", ["exact", "blocked"])
def test_lane_calls_split_inside_scan_evaluate(lane, monkeypatch):
    spans, stats, phases = lane_run(lane, "cpu", monkeypatch)
    assert_lane_split(spans, stats, phases)
    assert not [s for s in spans if s[0] == "scan_capture"]  # no graph
    for s in stats.values():
        assert s.replays == 0 == s.device_s  # no CUDA events
    # the eager loop is the replay span: one per lane call that ran steps
    assert sum(s[0] == "scan_replay" for s in spans) == sum(
        s.calls for s in stats.values())


def _eager_mesh_loop(step, state, n, log):
    mesh = sharding.Mesh([[torch.device("cpu", 0), torch.device("cpu", 1)]])
    sharding._run_mesh_steps(mesh, step, state, n, log)


@pytest.mark.parametrize("hook", [False, True])
@pytest.mark.parametrize("loop", [seq.run_steps, _eager_mesh_loop],
                         ids=["run_steps", "eager_mesh"])
def test_step_loop_keeps_its_log_with_or_without_a_hook(loop, hook,
                                                        monkeypatch):
    """A bare ``StepLog()`` (the no-op ``timed``) runs the loop as before;
    with a hook the eager loop is one ``scan_replay`` span.  On the CPU no
    replay is timed."""
    monkeypatch.setitem(kernels.launch_counts, "select_hosts", 0)
    state = {"i": torch.zeros((), dtype=torch.int64)}

    def step(st):
        st["i"] += 1

    metrics = SpanLog()
    log = seq.StepLog(timed=metrics.timed) if hook else seq.StepLog()
    loop(step, state, 5, log)
    loop(step, state, 0, log)  # no steps: no loop and no span
    assert int(state["i"]) == 5
    [stats] = log.loops
    assert (stats.steps, stats.replays, stats.device_s) == (5, 0, 0.0)
    assert stats.device_ms_per_step is None
    assert [s[0] for s in metrics.spans] == (["scan_replay"] if hook else [])
