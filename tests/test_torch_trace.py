"""The port's flight-recorder span ring (``observability/trace.py``) and its
span sites, against the JAX package's.

The trace tests of ``tests/test_telemetry.py`` run here on the port: the
ring is bounded and filterable, drops ``None`` fields, dumps only under
``MINISCHED_TRACE_DIR``; ``/debug/trace`` is served by ``metricsd`` and
the REST façade (with its route label); a live scheduler leaves an
enqueue → pop → bind → bind_ack chain; the queue's arrival stamp survives
a requeue.  Beside them: one seeded live run on each engine (the serial
path, the same cluster and uids) leaves the same sequence of spans, stage
for stage and pod for pod, with the same wave ids, nodes, attempts and
cycles (wall-clock fields aside).
"""

from __future__ import annotations

import json
import os
import time
import urllib.request

import pytest

from minisched_tpu.observability import trace as jtrace

from minisched_tpu_torch.api.objects import make_node, make_pod
from minisched_tpu_torch.controlplane.client import Client
from minisched_tpu_torch.controlplane.httpserver import (
    _route_label,
    start_api_server,
)
from minisched_tpu_torch.controlplane.store import ObjectStore
from minisched_tpu_torch.observability import hist, trace
from minisched_tpu_torch.observability.metricsd import start_metrics_server
from minisched_tpu_torch.queue.queue import SchedulingQueue
from minisched_tpu_torch.service.config import default_scheduler_config
from minisched_tpu_torch.service.service import SchedulerService

from tests.test_torch_engine import SIDES, live, overflow_cluster, settled


def test_trace_ring_bounded_and_filterable():
    ring = trace.TraceRing(capacity=8)
    for i in range(20):
        ring.span("enqueue", pod=f"default/p{i % 2}", seq=i)
    assert len(ring) == 8
    assert all(s["seq"] >= 12 for s in ring.spans())
    only_p1 = ring.spans(pod="default/p1")
    assert only_p1 and all(s["pod"] == "default/p1" for s in only_p1)
    lines = ring.dump_jsonl().strip().splitlines()
    assert len(lines) == 8
    assert all(json.loads(ln)["stage"] == "enqueue" for ln in lines)


def test_trace_span_drops_none_fields():
    ring = trace.TraceRing(capacity=8)
    ring.span("wave_build", wave=3, mesh=None, skipped=None)
    [s] = ring.spans()
    assert s["wave"] == 3 and "mesh" not in s and "skipped" not in s


def test_flight_dump_env_gated(tmp_path, monkeypatch):
    ring = trace.TraceRing(capacity=8)
    ring.span("wave_park", wave=1, cause="TestError")
    monkeypatch.delenv("MINISCHED_TRACE_DIR", raising=False)
    assert ring.flight_dump("no-dir") is None
    monkeypatch.setenv("MINISCHED_TRACE_DIR", str(tmp_path))
    path = ring.flight_dump("storage degraded/park!")
    assert path is not None and os.path.exists(path)
    assert "storage_degraded_park_" in os.path.basename(path)
    rec = json.loads(open(path).read().strip())
    assert rec["stage"] == "wave_park" and rec["cause"] == "TestError"


@pytest.mark.parametrize("cap,want", [("100", 100), ("3", 64), ("x", 8192)])
def test_trace_cap_from_env_as_jax(monkeypatch, cap, want):
    """``MINISCHED_TRACE_CAP`` sets the ring's size, floored at 64, with
    8,192 for a value that is not a number: as JAX's."""
    monkeypatch.setenv("MINISCHED_TRACE_CAP", cap)
    assert trace._default_cap() == jtrace._default_cap() == want
    ring = trace.TraceRing()
    for i in range(want + 10):
        ring.span("enqueue", seq=i)
    assert len(ring) == want


def _get(url: str) -> tuple:
    with urllib.request.urlopen(url, timeout=5.0) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read().decode()


def test_metricsd_serves_metrics_and_trace():
    hist.observe("sched.wave_build_s", 0.001)
    trace.span("wave_build", wave=999999, size=1)
    _srv, port, shutdown = start_metrics_server(port=0)
    try:
        status, ctype, body = _get(f"http://127.0.0.1:{port}/metrics")
        assert status == 200 and ctype.startswith("text/plain")
        types, _samples = hist.parse_prometheus(body)
        assert types.get("sched_wave_build_seconds") == "histogram"
        status, ctype, body = _get(f"http://127.0.0.1:{port}/debug/trace")
        assert status == 200 and "ndjson" in ctype
        assert any(json.loads(ln).get("wave") == 999999
                   for ln in body.strip().splitlines())
        status, _ct, body = _get(f"http://127.0.0.1:{port}/healthz")
        assert status == 200 and body == "ok"
    finally:
        shutdown()


def test_facade_serves_metrics_and_trace():
    assert _route_label("/debug/trace") == "/debug/trace"
    _server, base, shutdown = start_api_server(ObjectStore(), port=0)
    try:
        status, ctype, _body = _get(base + "/metrics")
        assert status == 200 and "version=0.0.4" in ctype
        trace.span("facade_probe", wave=424242)
        status, ctype, body = _get(base + "/debug/trace")
        assert status == 200 and "ndjson" in ctype
        assert any(json.loads(ln).get("wave") == 424242
                   for ln in body.strip().splitlines())
        # the handler observes its latency after the body is sent, so the
        # client can read the answer before the observation lands
        deadline = time.monotonic() + 10
        while True:
            child = hist.GLOBAL.get("http.request_s", verb="GET",
                                    route="/debug/trace")
            if (child is not None and child.count >= 1
                    or time.monotonic() > deadline):
                break
            time.sleep(0.01)
        assert child is not None and child.count >= 1
    finally:
        shutdown()


@pytest.mark.parametrize("device_mode", [False, True])
def test_scheduler_feeds_time_to_bind_and_trace(device_mode):
    """A live scheduler stamps arrival at admission, observes time to
    bind at the ack, and leaves an enqueue → pop → bind → bind_ack
    chain; on the device engine the bind carries its wave's id, which a
    ``wave_build`` span names."""
    name = f"ttb-pod-{int(device_mode)}"
    counts0 = hist.GLOBAL.merged("sched.time_to_bind_s")[3]
    client = Client()
    svc = SchedulerService(client)
    kw = {"device": "cpu"} if device_mode else {}
    svc.start_scheduler(default_scheduler_config(time_scale=0.01),
                        device_mode=device_mode, **kw)
    try:
        client.nodes().create(make_node("node1"))
        client.pods().create(make_pod(name))
        deadline = time.time() + 30
        while time.time() < deadline:
            if client.pods().get(name).spec.node_name:
                break
            time.sleep(0.05)
        got = client.pods().get(name)
    finally:
        svc.shutdown_scheduler()
    assert got.spec.node_name == "node1"
    assert hist.GLOBAL.merged("sched.time_to_bind_s")[3] > counts0
    stages = [s["stage"] for s in trace.spans(pod=f"default/{name}")]
    for stage in ("enqueue", "pop", "bind", "bind_ack"):
        assert stage in stages, stages
    assert (stages.index("enqueue") < stages.index("pop")
            < stages.index("bind") < stages.index("bind_ack"))
    [ack] = trace.spans(pod=f"default/{name}", stage="bind_ack")
    assert ack["ttb_s"] >= 0.0 and ack["node"] == "node1"
    if device_mode:
        [bind] = trace.spans(pod=f"default/{name}", stage="bind")
        assert any(s.get("wave") == bind["wave"]
                   for s in trace.spans(stage="wave_build"))


def test_queue_arrival_stamp_survives_requeue_and_purges_on_delete():
    now = {"t": 100.0}
    q = SchedulingQueue(clock=lambda: now["t"])
    pod = make_pod("stampy")
    q.add(pod)
    now["t"] = 105.0
    q.pop()
    q.add(pod, requeue=True)
    uid = q._uid(pod)
    assert q._arrival_ts[uid] == 100.0
    n0 = hist.GLOBAL.merged("sched.time_to_bind_s")[3]
    now["t"] = 108.0
    q.observe_bind(pod, "node-x")
    assert uid not in q._arrival_ts
    assert hist.GLOBAL.merged("sched.time_to_bind_s")[3] == n0 + 1
    q.observe_bind(pod, "node-x")
    assert hist.GLOBAL.merged("sched.time_to_bind_s")[3] == n0 + 1
    p2 = make_pod("stampy2")
    q.add(p2)
    assert q._uid(p2) in q._arrival_ts
    q.delete_many([p2])
    assert q._uid(p2) not in q._arrival_ts
    assert hist.GLOBAL.merged("sched.time_to_bind_s")[3] == n0 + 1
    p3 = make_pod("stampy3")
    q.add(p3)
    now["t"] = 111.0
    p3.spec.node_name = "node-y"
    q.delete_many([p3])
    assert q._uid(p3) not in q._arrival_ts
    assert hist.GLOBAL.merged("sched.time_to_bind_s")[3] == n0 + 2
    q.observe_bind(p3, "node-y")
    assert hist.GLOBAL.merged("sched.time_to_bind_s")[3] == n0 + 2


# -- one seeded live run, port against JAX ---------------------------------

#: per-process or wall-clock fields
CLOCKED = ("ts", "ttb_s", "build_s")


def _spans_of_run(side, monkeypatch, seed):
    ring = jtrace if side == "jax" else trace
    nodes, pods = overflow_cluster(SIDES[side][0], seed=seed, n_pods=48)
    ring.reset()
    with live(side, "default_full_roster_config", monkeypatch, nodes, pods,
              assume_ttl_s=0.5, time_scale=0.01) as (client, sched, _):
        assert wait_settled(client, sched, len(pods))
        spans = ring.spans()
    return [{k: v for k, v in s.items() if k not in CLOCKED} for s in spans]


def wait_settled(client, sched, n_pods, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if settled(client, sched, n_pods):
            return True
        time.sleep(0.02)
    return False


@pytest.mark.parametrize("seed", [0, 3])
def test_live_run_spans_equal_to_jax(monkeypatch, seed):
    """Serial waves of 16 over a cluster created before the engine
    starts, with more pods than fit: both engines record the same spans
    in the same order (enqueue at the informer sync, then per wave
    ``wave_build``, the wave's pops, its binds and acks)."""
    got = _spans_of_run("port", monkeypatch, seed)
    want = _spans_of_run("jax", monkeypatch, seed)
    stages = [s["stage"] for s in want]
    assert {"enqueue", "pop", "wave_build", "bind", "bind_ack"} <= set(stages)
    assert [(s["stage"], s.get("pod")) for s in got] == \
        [(s["stage"], s.get("pod")) for s in want]
    assert got == want
