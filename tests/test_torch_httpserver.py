"""The port's REST façade against the JAX package's, on the CPU.

Every case of ``tests/test_httpserver.py`` runs against the port's
façade; one script of raw requests goes to both façades and must get the
same status codes and, decoded into the port's objects, the same bodies;
watch resume within and past the history, the batch-bind ack registry,
and ``/metrics`` text equal to JAX's ``render_prometheus`` for the same
counters and histograms.  Comparisons are exact.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from minisched_tpu.controlplane import checkpoint as jcodec
from minisched_tpu.controlplane.client import Client as JClient
from minisched_tpu.controlplane.httpserver import (
    start_api_server as j_start_api_server,
)
from minisched_tpu.observability import counters as jcounters
from minisched_tpu.observability import hist as jhist

from minisched_tpu_torch.api.objects import (
    Binding,
    ObjectMeta,
    PersistentVolume,
    PVSpec,
    make_node,
    make_pod,
)
from minisched_tpu_torch.controlplane import codec as tcodec
from minisched_tpu_torch.controlplane.client import AlreadyBound, Client
from minisched_tpu_torch.controlplane.httpserver import (
    HTTPClient,
    REST_KINDS,
    start_api_server,
)
from minisched_tpu_torch.controlplane.store import HistoryCompacted, ObjectStore
from minisched_tpu_torch.observability import counters as tcounters
from minisched_tpu_torch.observability import hist as thist
from minisched_tpu_torch.observability import trace as ttrace
from minisched_tpu_torch.scenario.runner import ScenarioHarness, readme_scenario
from minisched_tpu_torch.service.config import default_scheduler_config
from minisched_tpu_torch.service.service import SchedulerService


@pytest.fixture()
def api():
    store_client = Client()
    _server, base, shutdown = start_api_server(store_client.store)
    try:
        yield store_client, HTTPClient(base), base
    finally:
        shutdown()


def raw(base, method, path, body=None, data=None):
    """(status, decoded JSON body) of one request."""
    if body is not None:
        data = json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


# -- the cases of tests/test_httpserver.py ----------------------------------


def test_crud_over_http(api):
    _, http, _ = api
    http.nodes().create(make_node("n1", labels={"zone": "a"}))
    assert http.nodes().get("n1").metadata.labels == {"zone": "a"}
    assert [n.metadata.name for n in http.nodes().list()] == ["n1"]
    http.pods().create(make_pod("p1", requests={"cpu": "500m"}))
    assert http.pods().get("p1").spec.containers[0].requests.milli_cpu == 500
    http.pods().delete("p1")
    with pytest.raises(KeyError):
        http.pods().get("p1")


def test_bind_subresource_and_conflict(api):
    _, http, _ = api
    http.nodes().create(make_node("n1"))
    http.pods().create(make_pod("p1"))
    assert http.pods().bind(Binding("p1", "default", "n1")).spec.node_name \
        == "n1"
    with pytest.raises(AlreadyBound):
        http.pods().bind(Binding("p1", "default", "n1"))
    with pytest.raises(KeyError):
        http.pods().bind(Binding("ghost", "default", "n1"))


def test_namespaced_create_uses_url_namespace(api):
    _, http, _ = api
    http.pods("team-a").create(make_pod("x"))
    assert http.pods("team-a").get("x").metadata.namespace == "team-a"


def test_put_rejects_path_body_mismatch(api):
    _, http, _ = api
    http.pods().create(make_pod("p1"))
    with pytest.raises(RuntimeError, match="400"):
        http._req("PUT", "/api/v1/namespaces/default/pods/p1",
                  tcodec._encode(make_pod("p2")))


def test_bare_api_v1_is_404_not_dropped_connection(api):
    _, _, base = api
    assert raw(base, "GET", "/api/v1")[0] == 404


def test_pv_create_then_get_roundtrips(api):
    """PVs are cluster-scoped: create, then get through the same API."""
    _, http, _ = api
    pv = PersistentVolume(metadata=ObjectMeta(name="pv1"),
                          spec=PVSpec(capacity=5))
    http._req("POST", "/api/v1/persistentvolumes", tcodec._encode(pv))
    got = tcodec._decode(PersistentVolume,
                         http._req("GET", "/api/v1/persistentvolumes/pv1"))
    assert got.spec.capacity == 5
    http._req("DELETE", "/api/v1/persistentvolumes/pv1")


def test_namespaced_list_filters(api):
    _, http, _ = api
    http.pods("team-a").create(make_pod("a"))
    http.pods().create(make_pod("b"))
    assert [p.metadata.name for p in http.pods("team-a").list()] == ["a"]
    assert [p.metadata.name for p in http.pods().list()] == ["b"]


def test_duplicate_create_raises_keyerror_like_in_process(api):
    _, http, _ = api
    http.nodes().create(make_node("dup"))
    with pytest.raises(KeyError):
        http.nodes().create(make_node("dup"))


def test_malformed_body_is_400(api):
    _, _, base = api
    assert raw(base, "POST", "/api/v1/nodes", data=b"not json")[0] == 400


def test_healthz_and_404(api):
    _, _, base = api
    assert raw(base, "GET", "/healthz") == (200, "ok")
    assert raw(base, "GET", "/api/v1/bogus")[0] == 404


def _read_watch(base, path, n, out):
    with urllib.request.urlopen(base + path, timeout=10) as req:
        for line in req:
            line = line.strip()
            if line:
                out.append(json.loads(line))
            if len(out) >= n:
                break


def test_watch_streams_events(api):
    store_client, http, base = api
    events = []
    t = threading.Thread(target=_read_watch, daemon=True, args=(
        base, "/api/v1/namespaces/default/pods?watch=true", 3, events))
    t.start()
    time.sleep(0.2)
    http.pods().create(make_pod("w1"))
    store_client.pods().bind(Binding("w1", "default", "x"))  # MODIFIED
    t.join(timeout=5)
    assert not t.is_alive()
    # the SYNC marker carries the snapshot count, then the live events
    assert [e["type"] for e in events[:3]] == ["SYNC", "ADDED", "MODIFIED"]
    assert events[0]["count"] == 0
    assert events[1]["object"]["metadata"]["name"] == "w1"


@pytest.mark.parametrize("device_mode", [False, True])
def test_readme_scenario_over_http(api, device_mode):
    """sched.go:70-143 with the scenario on the REST boundary; the scheduler
    runs in process against the store the server fronts.  Both engines
    (the device engine on the CPU twins)."""
    store_client, http, _ = api
    svc = SchedulerService(store_client)
    svc.start_scheduler(default_scheduler_config(time_scale=0.01),
                        device_mode=device_mode, device="cpu")
    try:
        for i in range(9):
            http.nodes().create(make_node(f"node{i}", unschedulable=True))
        http.pods().create(make_pod("pod1"))
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            if svc.scheduler.queue.stats()["unschedulable"] == 1:
                break
            time.sleep(0.02)
        assert http.pods().get("pod1").spec.node_name == ""
        http.nodes().create(make_node("node10"))
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if http.pods().get("pod1").spec.node_name == "node10":
                break
            time.sleep(0.02)
        assert http.pods().get("pod1").spec.node_name == "node10"
        assert svc.scheduler.loop_errors == 0
    finally:
        svc.shutdown_scheduler()


def test_scheduler_events_visible_over_rest():
    """Scheduled and FailedScheduling decisions are Event objects, listed
    over the façade."""
    with ScenarioHarness(default_scheduler_config(time_scale=0.01),
                         device="cpu") as h:
        assert readme_scenario(h, log=lambda *_: None) == "node10"
        h.service.recorder.flush()  # event writes are asynchronous
        _server, base, shutdown = start_api_server(h.client.store)
        try:
            status, body = raw(base, "GET", "/api/v1/events")
        finally:
            shutdown()
    assert status == 200
    items = body["items"]
    reasons = {e["reason"] for e in items}
    assert {"Scheduled", "FailedScheduling"} <= reasons, reasons
    scheduled = [e for e in items if e["reason"] == "Scheduled"]
    assert any("node10" in e["message"] for e in scheduled)
    assert all(e["metadata"]["namespace"] == "default" for e in scheduled)


# -- both façades, one script -----------------------------------------------

VOLATILE = ("uid", "creation_timestamp")


def _normalized(kind, doc):
    """A body decoded into the port's objects and encoded again (fields
    the port's objects lack drop out), without the per-process fields."""
    if not isinstance(doc, dict) or "metadata" not in doc:
        return doc
    out = tcodec._encode(tcodec._decode(REST_KINDS[kind], doc))
    for k in VOLATILE:
        out["metadata"].pop(k, None)
    return out


def _normalize_body(kind, body):
    if isinstance(body, dict) and "error" in body:
        return {k: v for k, v in body.items() if k != "error"}
    if isinstance(body, dict) and isinstance(body.get("items"), list):
        return dict(body, items=[
            _normalize_body(kind, it) if "error" in it or "acked" in it
            or "object" in it or not it else _normalized(kind, it)
            for it in body["items"]])
    if isinstance(body, dict) and "object" in body:
        return dict(body, object=_normalized(kind, body["object"]))
    return _normalized(kind, body)


def _script(codec):
    enc = codec._encode
    from importlib import import_module

    objs = import_module(codec.__name__.rsplit(".", 2)[0] + ".api.objects")
    node = enc(objs.make_node("n1", labels={"zone": "a"},
                              capacity={"cpu": "2", "memory": "4Gi",
                                        "pods": 110}))
    pod = enc(objs.make_pod("p1", requests={"cpu": "500m"}))
    big = enc(objs.make_pod("big", requests={"cpu": "8"}))
    other = enc(objs.make_pod("p2"))
    pv = enc(objs.PersistentVolume(metadata=objs.ObjectMeta(name="pv1"),
                                   spec=objs.PVSpec(capacity=5)))
    return [
        ("Node", "GET", "/healthz", None),
        ("Node", "POST", "/api/v1/nodes", node),
        ("Node", "POST", "/api/v1/nodes", node),
        ("Node", "GET", "/api/v1/nodes/n1", None),
        ("Node", "GET", "/api/v1/nodes/nope", None),
        ("Pod", "POST", "/api/v1/namespaces/default/pods", pod),
        ("Pod", "POST", "/api/v1/namespaces/team-a/pods", other),
        ("Pod", "GET", "/api/v1/namespaces/team-a/pods/p2", None),
        ("Pod", "PUT", "/api/v1/namespaces/default/pods/p1", other),
        ("Pod", "PUT", "/api/v1/namespaces/default/pods/p1?expected_rv=1",
         pod),
        ("Pod", "PUT", "/api/v1/namespaces/default/pods/p1?expected_rv=x",
         pod),
        ("Pod", "POST", "/api/v1/namespaces/default/pods",
         {"items": [other, pod, big], "return_objects": True}),
        ("Pod", "POST", "/api/v1/namespaces/default/pods/p1/binding",
         {"node_name": "n1"}),
        ("Pod", "POST", "/api/v1/namespaces/default/pods/p1/binding",
         {"node_name": "n1"}),
        ("Pod", "POST", "/api/v1/namespaces/default/pods/p1/binding", {}),
        ("Pod", "POST", "/api/v1/namespaces/default/pods/ghost/binding",
         {"node_name": "n1"}),
        ("Pod", "POST", "/api/v1/bindings", {"batch_id": "b1", "items": [
            {"name": "p2", "node_name": "n1"},
            {"name": "big", "node_name": "n1"},
            {"name": "ghost", "node_name": "n1"}]}),
        ("Pod", "POST", "/api/v1/bindings", {"batch_id": "b1", "items": [
            {"name": "p2", "node_name": "n1"},
            {"name": "big", "node_name": "n1"},
            {"name": "ghost", "node_name": "n1"}]}),
        ("Pod", "POST", "/api/v1/bindings", {"items": [{"name": "p2"}]}),
        ("Pod", "GET", "/api/v1/namespaces/default/pods?min_rv=999999", None),
        ("Pod", "GET", "/api/v1/namespaces/default/pods?min_rv=z", None),
        ("Pod", "GET", "/api/v1/namespaces/default/pods", None),
        ("Pod", "GET", "/api/v1/namespaces/default/pods?watch=true&"
                       "resource_version=999999", None),
        ("PersistentVolume", "POST", "/api/v1/persistentvolumes", pv),
        ("PersistentVolume", "GET", "/api/v1/persistentvolumes/pv1", None),
        ("Pod", "DELETE", "/api/v1/namespaces/default/pods/p1", None),
        ("Pod", "DELETE", "/api/v1/namespaces/default/pods/p1", None),
        ("Node", "GET", "/api/v1", None),
        ("Node", "GET", "/api/v1/bogus", None),
        ("Node", "GET", "/shards/status", None),
        ("Node", "POST", "/shards/control", {}),
        ("Node", "GET", "/repl/status", None),
        ("Node", "POST", "/api/v1/nodes", None),
    ]


def _run_script(base, codec):
    out = []
    for kind, method, path, body in _script(codec):
        if body is None and method == "POST":
            status, got = raw(base, method, path, data=b"not json")
        else:
            status, got = raw(base, method, path, body)
        out.append((method, path, status, _normalize_body(kind, got)))
    return out


def test_same_requests_same_answers_as_jax():
    jclient = JClient()
    _s, jbase, jshutdown = j_start_api_server(jclient.store)
    _s, tbase, tshutdown = start_api_server(ObjectStore())
    try:
        want = _run_script(jbase, jcodec)
        got = _run_script(tbase, tcodec)
    finally:
        jshutdown()
        tshutdown()
    assert [g[:3] for g in got] == [w[:3] for w in want]
    assert got == want
    statuses = {g[2] for g in got}
    assert {200, 201, 400, 404, 409, 410, 504} <= statuses


# -- watch resume ------------------------------------------------------------


def test_watch_resume_within_history_and_past_it():
    store = ObjectStore(history_events=4)
    client = Client(store)
    _server, base, shutdown = start_api_server(store)
    try:
        for i in range(3):
            client.pods().create(make_pod(f"r{i}"))
        cursor = store.resource_version  # the consumer saw r0..r2
        client.pods().create(make_pod("r3"))
        client.pods().bind(Binding("r3", "default", "n1"))
        events = []
        _read_watch(base, "/api/v1/namespaces/default/pods?watch=true&"
                          f"resource_version={cursor}", 3, events)
        assert events[0] == {"type": "SYNC", "count": 0, "rv": cursor}
        assert [(e["type"], e["object"]["metadata"]["name"])
                for e in events[1:]] == [("ADDED", "r3"), ("MODIFIED", "r3")]
        for i in range(4, 8):  # the ring (4 events) drops the cursor's tail
            client.pods().create(make_pod(f"r{i}"))
        status, body = raw(base, "GET", "/api/v1/namespaces/default/pods?"
                                        f"watch=true&resource_version={cursor}")
        assert status == 410 and "compacted" in body["error"]
        with pytest.raises(HistoryCompacted):
            store.watch("Pod", resume_rv=cursor)
        # resuming at the head replays nothing and goes live
        w, snap = store.watch("Pod", resume_rv=store.resource_version)
        assert snap == [] and w.next_batch(timeout=0) == []
        w.stop()
        assert store.history_stats("Pod")["events"] == 4
    finally:
        shutdown()


def test_repeated_batch_id_is_acked(api):
    store_client, _http, base = api
    store_client.nodes().create(make_node("n1"))
    for i in range(3):
        store_client.pods().create(make_pod(f"b{i}"))
    req = {"batch_id": "wave-7", "items": [
        {"name": f"b{i}", "node_name": "n1"} for i in range(3)]}
    status, first = raw(base, "POST", "/api/v1/bindings", req)
    assert status == 200 and all("object" in e for e in first["items"])
    status, again = raw(base, "POST", "/api/v1/bindings", req)
    assert status == 200
    assert [e["acked"] for e in again["items"]] == [True] * 3
    assert all("error" not in e and e["object"]["spec"]["node_name"] == "n1"
               for e in again["items"])
    # without the batch id the retry is a plain double bind
    status, plain = raw(base, "POST", "/api/v1/bindings",
                        {"items": req["items"]})
    assert [e["type"] for e in plain["items"]] == ["AlreadyBound"] * 3
    assert [e["node"] for e in plain["items"]] == ["n1"] * 3


# -- /metrics ------------------------------------------------------------------


def _fill(counters, hist):
    counters.inc("sched.binds", 7)
    counters.inc("watch.fanout.encoded")
    counters.set_gauge("mesh.devices", 1)
    for v, prio in ((0.0004, "0"), (0.05, "0"), (3.0, "100"), (1e5, "0")):
        hist.observe("sched.time_to_bind_s", v, priority=prio)
    hist.observe("http.request_s", 0.002, exemplar='pod "x"\n',
                 verb="GET", route="pod/{name}")


def test_metrics_text_equal_to_jax_and_parsed_back(api):
    t_c, t_h = tcounters.Counters(), thist.Histograms()
    j_c, j_h = jcounters.Counters(), jhist.Histograms()
    _fill(t_c, t_h)
    _fill(j_c, j_h)
    text = thist.render_prometheus(t_c, t_h)
    assert text == jhist.render_prometheus(j_c, j_h)
    types, samples = thist.parse_prometheus(text)
    assert (types, samples) == jhist.parse_prometheus(text)
    assert types["sched_time_to_bind_seconds"] == "histogram"
    assert types["mesh_devices"] == "gauge"
    count = [v for n, _l, v in samples
             if n == "sched_time_to_bind_seconds_count"]
    assert sum(count) == 4
    assert thist.parsed_histogram_quantile(
        samples, "sched_time_to_bind_seconds", 0.5) == (
        jhist.parsed_histogram_quantile(
            samples, "sched_time_to_bind_seconds", 0.5))
    assert thist.parse_exemplars(text) == jhist.parse_exemplars(text)
    # the façade serves the process-global registries
    tcounters.inc("test.metrics.scraped")
    _store, _http, base = api
    with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
        served = r.read().decode()
        assert r.headers["Content-Type"].startswith("text/plain")
    types, samples = thist.parse_prometheus(served)
    assert ("test_metrics_scraped", {}, float(
        tcounters.get("test.metrics.scraped"))) in samples


def test_metricsd_serves_the_registries():
    """``start_metrics_server`` for an engine without a façade: the same
    exposition on ``/metrics``, ``/healthz``, the JSON snapshot and the
    trace ring on ``/debug/trace``, and 404 for what it does not serve."""
    from minisched_tpu_torch.observability.metricsd import (
        start_metrics_server,
    )

    thist.observe("test.metricsd_s", 0.25)
    _srv, port, shutdown = start_metrics_server()
    base = f"http://127.0.0.1:{port}"
    try:
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            types, samples = thist.parse_prometheus(r.read().decode())
        assert types["test_metricsd_seconds"] == "histogram"
        assert ("test_metricsd_seconds_count", {}, 1.0) in samples
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert r.read() == b"ok"
        with urllib.request.urlopen(base + "/debug/metrics.json",
                                    timeout=10) as r:
            assert json.loads(r.read())["test.metricsd_s"]["count"] == 1
        ttrace.span("test_metricsd", wave=999999)
        with urllib.request.urlopen(base + "/debug/trace", timeout=10) as r:
            assert "ndjson" in r.headers["Content-Type"]
            assert any(json.loads(ln).get("wave") == 999999
                       for ln in r.read().decode().splitlines())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/debug/nothing", timeout=10)
        assert e.value.code == 404
    finally:
        shutdown()
