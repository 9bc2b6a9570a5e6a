"""The port's gRPC servicer (``minisched_tpu_torch/controlplane/grpcserver.py``)
against the JAX package's.

Every test of ``tests/test_grpc.py`` runs here on the port's server (its
evaluator on the CPU twins).  Beside them: the framing bytes equal JAX's
``_wrap_json`` on seeded random payloads; ``Evaluate`` answers equal the
JAX servicer's on a seeded cluster with every feature, in both modes;
``List`` and ``Watch`` (initial sync, live events, resume, the refusals)
equal a JAX server's event for event on the same mutations, without the
per-process fields (uid, creation timestamp); an over-limit request is
refused ``RESOURCE_EXHAUSTED`` by both (grpc's default 4 MiB).  Tolerance
0: placements and messages are compared for equality.
"""

from __future__ import annotations

import json
import os
import random

import pytest

grpc = pytest.importorskip("grpc")

from minisched_tpu.api import objects as jobj
from minisched_tpu.controlplane import grpcserver as jgrpc
from minisched_tpu.controlplane.store import ObjectStore as JStore

from minisched_tpu_torch.api import objects as tobj
from minisched_tpu_torch.api.objects import make_node, make_pod
from minisched_tpu_torch.controlplane import codec as tcodec
from minisched_tpu_torch.controlplane import grpcserver as tgrpc
from minisched_tpu_torch.controlplane.grpcserver import (
    EvaluatorClient,
    start_grpc_server,
)
from minisched_tpu_torch.controlplane.store import ObjectStore
from minisched_tpu_torch.observability import counters

from tests.test_torch_evaluate import feature_request


@pytest.fixture(scope="module")
def server():
    _srv, address, shutdown = start_grpc_server(device="cpu")
    yield address
    shutdown()


@pytest.fixture(scope="module")
def jserver():
    _srv, address, shutdown = jgrpc.start_grpc_server()
    yield address
    shutdown()


# -- the JAX tests, on the port --------------------------------------------


def test_health(server):
    client = EvaluatorClient(server)
    assert client.health() == {"ok": True}
    client.close()


def test_evaluate_matches_scalar_oracle(server):
    """Placements over the wire == the scalar full-roster oracle."""
    from minisched_tpu_torch.engine.scheduler import schedule_pod_once
    from minisched_tpu_torch.framework.nodeinfo import build_node_infos
    from minisched_tpu_torch.framework.types import FitError
    from minisched_tpu_torch.plugins.registry import build_plugins
    from minisched_tpu_torch.service.config import default_full_roster_config

    rng = random.Random(7)
    nodes = sorted(
        (make_node(f"n{i:02d}", unschedulable=rng.random() < 0.25,
                   capacity={"cpu": "4", "memory": "8Gi", "pods": 110})
         for i in range(12)),
        key=lambda n: n.metadata.name)
    assigned = []
    for i in range(5):
        p = make_pod(f"a{i}", requests={"cpu": "1"})
        p.metadata.uid = f"a{i}"
        p.spec.node_name = rng.choice(nodes).metadata.name
        assigned.append(p)
    pods = [make_pod(f"p{i}", requests={"cpu": rng.choice(["500m", "1"])})
            for i in range(8)]

    client = EvaluatorClient(server)
    out = client.evaluate(nodes, pods, assigned=assigned, mode="wave")
    client.close()
    placements = out["placements"]
    assert set(placements) == {p.metadata.key for p in pods}

    cfg = default_full_roster_config()
    chains = build_plugins(cfg)
    infos = build_node_infos(nodes, assigned)
    for pod in pods:
        try:
            want = schedule_pod_once(chains.filter, chains.pre_score,
                                     chains.score, cfg.score_weights(), pod,
                                     infos)
        except FitError:
            want = None
        assert placements[pod.metadata.key] == want, pod.metadata.name


def test_evaluate_repair_never_overcommits(server):
    nodes = [make_node(f"n{i}", capacity={"cpu": "1", "memory": "4Gi",
                                          "pods": 110}) for i in range(3)]
    pods = [make_pod(f"p{i}", requests={"cpu": "600m"}) for i in range(6)]
    client = EvaluatorClient(server)
    out = client.evaluate(nodes, pods, mode="repair")
    client.close()
    per_node: dict = {}
    for _key, node in out["placements"].items():
        if node is not None:
            per_node[node] = per_node.get(node, 0) + 1
    assert sum(per_node.values()) == 3  # one 600m pod per 1-cpu node
    assert all(c == 1 for c in per_node.values())


def test_bad_mode_is_invalid_argument(server):
    client = EvaluatorClient(server)
    with pytest.raises(grpc.RpcError) as err:
        client._call("Evaluate", {"nodes": [], "pods": [], "mode": "bogus"})
    assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    client.close()


def test_proto_contract_compiles_with_protoc(tmp_path):
    """The wire contract the port speaks is the repo's
    ``proto/minisched_evaluator.proto``: the system protoc accepts it."""
    import shutil
    import subprocess

    if shutil.which("protoc") is None:
        pytest.skip("protoc not installed")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        ["protoc", f"--proto_path={os.path.join(root, 'proto')}",
         f"--descriptor_set_out={tmp_path / 'ev.desc'}",
         "minisched_evaluator.proto"],
        capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    assert (tmp_path / "ev.desc").stat().st_size > 0


def test_json_framing_matches_protobuf_wire_format():
    for payload in (b"{}", b'{"ok": true}', b"x" * 1, b"y" * 127, b"z" * 300):
        wrapped = tgrpc._wrap_json(payload)
        assert wrapped[0] == 0x0A
        assert tgrpc._unwrap_json(wrapped) == payload
    assert tgrpc._wrap_json(b"") == b""
    assert tgrpc._unwrap_json(b"") == b"{}"
    assert tgrpc._unwrap_json(b'{"mode": "wave"}') == b'{"mode": "wave"}'


def test_evaluator_accepts_legacy_raw_json_frames(server):
    channel = grpc.insecure_channel(server)
    fn = channel.unary_unary(f"/{tgrpc.SERVICE}/Evaluate",
                             request_serializer=lambda b: b,
                             response_deserializer=lambda b: b)
    payload = {"nodes": [tcodec._encode(make_node("n1"))],
               "pods": [tcodec._encode(make_pod("p1"))], "mode": "wave"}
    raw = fn(json.dumps(payload).encode(), timeout=60.0)
    out = json.loads(tgrpc._unwrap_json(raw).decode())
    assert out["placements"] == {"default/p1": "n1"}
    channel.close()


@pytest.fixture()
def store_server():
    store = ObjectStore()
    _srv, address, shutdown = start_grpc_server(store=store, device="cpu")
    yield store, address
    shutdown()


def test_watch_initial_sync_then_live(store_server):
    store, address = store_server
    store.create("Node", make_node("w-n1"))
    store.create("Pod", make_pod("w-p1"))
    client = EvaluatorClient(address)
    w = client.watch("Pod")
    try:
        assert next(w)["sync"] == 1
        first = next(w)
        assert first["type"] == "ADDED"
        assert first["object"]["metadata"]["name"] == "w-p1"
        store.create("Pod", make_pod("w-p2"))
        live = next(w)
        assert live["object"]["metadata"]["name"] == "w-p2"
        assert live["resource_version"] > first["resource_version"]
    finally:
        w.cancel()
        client.close()


def test_watch_resume_replays_exactly_after_rv(store_server):
    store, address = store_server
    store.create("Pod", make_pod("r-p1"))
    rv1 = store.get("Pod", "default", "r-p1").metadata.resource_version
    store.create("Pod", make_pod("r-p2"))
    client = EvaluatorClient(address)
    w = client.watch("Pod", resume_rv=rv1)
    try:
        assert next(w)["sync"] == 0
        assert next(w)["object"]["metadata"]["name"] == "r-p2"
    finally:
        w.cancel()
        client.close()


def test_watch_resume_past_history_is_out_of_range(store_server):
    _store, address = store_server
    client = EvaluatorClient(address)
    w = client.watch("Pod", resume_rv=10**9)
    try:
        with pytest.raises(grpc.RpcError) as e:
            next(w)
        assert e.value.code() == grpc.StatusCode.OUT_OF_RANGE
    finally:
        client.close()


def test_watch_shares_one_encode_across_streams(store_server):
    store, address = store_server
    client = EvaluatorClient(address)
    watches = [client.watch("Pod", send_initial=False) for _ in range(4)]
    try:
        for w in watches:
            assert next(w)["sync"] == 0
        base_enc = counters.get("grpc.watch.encoded")
        base_shared = counters.get("grpc.watch.shared")
        store.create("Pod", make_pod("shared-p"))
        for w in watches:
            assert next(w)["object"]["metadata"]["name"] == "shared-p"
        assert counters.get("grpc.watch.encoded") - base_enc <= 2
        assert counters.get("grpc.watch.shared") - base_shared >= 2
    finally:
        for w in watches:
            w.cancel()
        client.close()


# -- the port against the JAX servicer -------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_framing_bytes_equal_jax(seed):
    """``_wrap_json``/``_varint`` byte for byte with JAX's, on seeded
    random payloads whose lengths cross every varint width up to three
    bytes; both unwrap each other's frames."""
    rng = random.Random(seed)
    for n in [0, 1, 127, 128, 16383, 16384] + [rng.randrange(1, 1 << 18)
                                               for _ in range(20)]:
        payload = bytes(rng.randrange(256) for _ in range(n))
        assert tgrpc._varint(n) == jgrpc._varint(n)
        assert tgrpc._read_varint(tgrpc._varint(n), 0) == \
            jgrpc._read_varint(jgrpc._varint(n), 0)
        wrapped = tgrpc._wrap_json(payload)
        assert wrapped == jgrpc._wrap_json(payload)
        assert tgrpc._unwrap_json(wrapped) == jgrpc._unwrap_json(wrapped)
    for bad in (b"\x0a", b"\x0a\x05ab", b"\x0a" + b"\xff" * 10):
        with pytest.raises(ValueError):
            tgrpc._unwrap_json(bad)
        with pytest.raises(ValueError):
            jgrpc._unwrap_json(bad)


@pytest.mark.parametrize("mode", ["wave", "repair"])
def test_evaluate_equal_to_jax_servicer(server, jserver, mode):
    """One seeded request with every feature the plugins read, over the
    wire into both servicers: equal placements and rounds."""
    request, _objects = feature_request(seed=5)
    request = dict(request, mode=mode)
    got = EvaluatorClient(server)._call("Evaluate", request)
    want = EvaluatorClient(jserver)._call("Evaluate", request)
    assert got == want
    assert sum(v is not None for v in got["placements"].values()) > 0


def test_malformed_request_invalid_argument_as_jax(server, jserver):
    bad = {"nodes": [{"metadata": 5}], "pods": [{"metadata": 5}]}
    codes = []
    for address in (server, jserver):
        client = EvaluatorClient(address)
        with pytest.raises(grpc.RpcError) as err:
            client._call("Evaluate", bad)
        codes.append(err.value.code())
        client.close()
    assert codes == [grpc.StatusCode.INVALID_ARGUMENT] * 2


def test_over_limit_request_refused_as_jax(server, jserver):
    """grpc's default 4 MiB receive limit holds on both servers: a larger
    request is refused before the servicer sees it."""
    pad = {"nodes": [], "pods": [], "pad": "x" * (5 << 20)}
    codes = []
    for address in (server, jserver):
        client = EvaluatorClient(address)
        with pytest.raises(grpc.RpcError) as err:
            client._call("Evaluate", pad)
        codes.append(err.value.code())
        client.close()
    assert codes == [grpc.StatusCode.RESOURCE_EXHAUSTED] * 2


VOLATILE = ("uid", "creation_timestamp")


def _norm(msg):
    """A watch or list message without the per-process fields, its objects
    decoded into the port's types and encoded again."""
    def obj(doc):
        kind = tcodec.KIND_TYPES["Pod" if "spec" in doc and "containers"
                                 in doc["spec"] else "Node"]
        out = tcodec._encode(tcodec._decode(kind, doc))
        for k in VOLATILE:
            out["metadata"].pop(k, None)
        return out

    if "object" in msg:
        return dict(msg, object=obj(msg["object"]))
    if "items" in msg:
        return dict(msg, items=[obj(o) for o in msg["items"]])
    return msg


def _mutate(objs, store, rng):
    """One seeded sequence of creates, updates, binds and deletes."""
    store.create("Node", objs.make_node("m-n0"))
    for i in range(6):
        store.create("Pod", objs.make_pod(
            f"m-p{i}", namespace=rng.choice(["default", "team-a"]),
            requests={"cpu": f"{rng.randrange(1, 4) * 100}m"}))
    for pod in sorted(store.list("Pod"), key=lambda p: p.metadata.name)[:3]:
        pod.metadata.labels["touched"] = "yes"
        store.update("Pod", pod)
    for pod in sorted(store.list("Pod"), key=lambda p: p.metadata.name)[3:5]:
        pod.spec.node_name = "m-n0"
        store.update("Pod", pod)
    victim = sorted(store.list("Pod"), key=lambda p: p.metadata.name)[-1]
    store.delete("Pod", victim.metadata.namespace, victim.metadata.name)


def _drain(w, n):
    return [next(w) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1])
def test_list_and_watch_equal_to_jax(seed):
    """The same seeded mutations on a JAX store and the port's, each
    served by its own servicer: the sync line, every live event, a
    resumed replay, ``List`` (with a namespace) and the refusals
    (``min_rv`` past the applied rv, a resume past the history) are
    equal message for message."""
    sides = []
    for objs, store, start in ((jobj, JStore(), jgrpc.start_grpc_server),
                               (tobj, ObjectStore(), start_grpc_server)):
        _srv, address, shutdown = start(store=store)
        client = (jgrpc.EvaluatorClient if objs is jobj
                  else EvaluatorClient)(address)
        try:
            store.create("Pod", objs.make_pod("pre-0"))
            w = client.watch("Pod")
            head = _drain(w, 2)  # sync line, then the replayed pre-0
            rng = random.Random(seed)
            _mutate(objs, store, rng)
            live = _drain(w, 6 + 3 + 2 + 1)
            w.cancel()
            resume_at = live[5]["resource_version"]
            r = client.watch("Pod", resume_rv=resume_at)
            resumed = _drain(r, 1 + 6)
            r.cancel()
            listed = [client.list("Pod"), client.list("Pod", "team-a"),
                      client.list("Node")]
            codes = []
            with pytest.raises(grpc.RpcError) as err:
                client._call("List", {"kind": "Pod", "min_rv": 10**6})
            codes.append(err.value.code())
            with pytest.raises(grpc.RpcError) as err:
                client._call("List", {"kind": "Bogus"})
            codes.append(err.value.code())
            with pytest.raises(grpc.RpcError) as err:
                next(client.watch("Pod", resume_rv=10**6))
            codes.append(err.value.code())
        finally:
            client.close()
            shutdown()
        for m in listed:
            m["items"].sort(key=lambda o: o["metadata"]["name"])
        sides.append(([_norm(m) for m in head + live], [_norm(m)
                      for m in resumed], [_norm(m) for m in listed], codes))
    assert sides[0] == sides[1]
    assert sides[1][3] == [grpc.StatusCode.UNAVAILABLE,
                           grpc.StatusCode.INVALID_ARGUMENT,
                           grpc.StatusCode.OUT_OF_RANGE]


def test_watch_eviction_out_of_range_as_jax(monkeypatch):
    """A stream whose buffer would pass ``DEFAULT_WATCH_STREAM_EVENTS``
    is evicted with ``OUT_OF_RANGE`` (bound cut to 4 on both sides; one
    batch create of 5 pods is one fan-out)."""
    monkeypatch.setattr(tgrpc, "DEFAULT_WATCH_STREAM_EVENTS", 4)
    monkeypatch.setattr(jgrpc, "DEFAULT_WATCH_STREAM_EVENTS", 4)
    codes = []
    for objs, store, start, cls in (
            (jobj, JStore(), jgrpc.start_grpc_server, jgrpc.EvaluatorClient),
            (tobj, ObjectStore(), start_grpc_server, EvaluatorClient)):
        _srv, address, shutdown = start(store=store)
        client = cls(address)
        try:
            w = client.watch("Pod", send_initial=False)
            assert next(w)["sync"] == 0
            store.create_many("Pod", [objs.make_pod(f"e{i}")
                                      for i in range(5)])
            with pytest.raises(grpc.RpcError) as err:
                next(w)
            codes.append(err.value.code())
        finally:
            client.close()
            shutdown()
    assert codes == [grpc.StatusCode.OUT_OF_RANGE] * 2


def test_external_watcher_process_sees_every_bind():
    """``live.count_grpc_binds`` (phase 26(b)'s watcher) in its own
    process against a store binding 300 pods in batches: every bind seen
    on its node, in resource_version order, no error."""
    import multiprocessing

    from minisched_tpu_torch.live import count_grpc_binds

    store = ObjectStore()
    store.create("Node", make_node("n1"))
    pods = [make_pod(f"b{i:03d}") for i in range(300)]
    store.create_many("Pod", pods)
    _srv, address, shutdown = start_grpc_server(store=store, device="cpu")
    ctx = multiprocessing.get_context("spawn")
    from_watcher, to_parent = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=count_grpc_binds,
                       args=(address, len(pods), to_parent), daemon=True)
    proc.start()
    try:
        assert from_watcher.poll(120)
        assert from_watcher.recv()["sync"] == 0

        def bind(p):
            p.spec.node_name = "n1"
            return p

        for i in range(0, len(pods), 100):
            store.mutate_many("Pod", [(p.metadata.namespace, p.metadata.name,
                                       bind) for p in pods[i:i + 100]])
        assert from_watcher.poll(120)
        seen = from_watcher.recv()
    finally:
        proc.join(30)
        if proc.is_alive():
            proc.terminate()
        shutdown()
    assert seen["error"] is None and seen["rv_ordered"]
    assert seen["bound"] == {p.metadata.name: "n1" for p in pods}
    assert seen["events"] == len(pods)


# -- the port's one addition: several watch events a message ---------------


@pytest.mark.parametrize("batch,cap", [(2, 1 << 20), (64, 1 << 20),
                                       (64, 2048)])
def test_batched_frames_hold_every_event_in_order(monkeypatch, batch, cap):
    """``_batched`` groups the memoized event frames into messages of at
    most ``batch`` events and ``WATCH_BATCH_BYTES`` of event JSON (a
    larger event alone), in order; at ``batch`` 1 it returns the frames
    themselves, JAX's wire."""
    monkeypatch.setattr(tgrpc, "WATCH_BATCH_BYTES", cap)
    rng = random.Random(batch + cap)
    lines = [json.dumps({"type": "MODIFIED", "resource_version": i,
                         "object": {"pad": "x" * rng.randrange(1, 3000)}}
                        ).encode() for i in range(300)]
    frames = [tgrpc._wrap_json(line) for line in lines]
    assert tgrpc._batched(frames, 1) is frames
    messages = tgrpc._batched(frames, batch)
    got = []
    for message in messages:
        events = json.loads(tgrpc._unwrap_json(message))["events"]
        sizes = [len(json.dumps(e)) for e in events]
        assert 1 <= len(events) <= batch
        assert len(events) == 1 or sum(sizes) <= cap
        got += events
    assert got == [json.loads(line) for line in lines]
    assert len(messages) < len(frames)


@pytest.mark.parametrize("batch", [2, 64])
def test_batched_watch_equal_to_one_event_a_message(store_server, batch):
    """Two streams on one store, one event a message and ``batch`` events
    a message, through a seeded sequence of mutations with a batch create
    of 100 pods: the iterators yield the same events in the same order,
    and the batched stream reads fewer messages."""
    store, address = store_server
    client = EvaluatorClient(address)
    single = client.watch("Pod", send_initial=False)
    batched = client.watch("Pod", send_initial=False, batch=batch)
    try:
        assert next(single)["sync"] == next(batched)["sync"] == 0
        store.create_many("Pod", [make_pod(f"bw{batch}-{i:03d}")
                                  for i in range(100)])
        rng = random.Random(batch)
        for i in range(20):
            pod = store.get("Pod", "default",
                            f"bw{batch}-{rng.randrange(100):03d}")
            pod.metadata.labels["step"] = str(i)
            store.update("Pod", pod)
        n = 100 + 20
        assert _drain(batched, n) == _drain(single, n)
        assert batched.messages < single.messages == n + 1
    finally:
        single.cancel()
        batched.cancel()
        client.close()


def test_batched_request_to_jax_server_reads_as_one_event_a_message():
    """A JAX server ignores ``batch`` and sends one event a message; the
    port's client reads the same events from it either way."""
    store = JStore()
    _srv, address, shutdown = jgrpc.start_grpc_server(store=store)
    client = EvaluatorClient(address)
    try:
        plain = client.watch("Pod", send_initial=False)
        asked = client.watch("Pod", send_initial=False, batch=64)
        assert next(plain)["sync"] == next(asked)["sync"] == 0
        store.create_many("Pod", [jobj.make_pod(f"j{i}") for i in range(10)])
        assert _drain(asked, 10) == _drain(plain, 10)
        assert asked.messages == plain.messages == 11
        plain.cancel()
        asked.cancel()
    finally:
        client.close()
        shutdown()


def test_external_watcher_process_sees_every_bind_batched():
    """Phase 26(b)'s watcher asking for up to 64 events a message, in its
    own process, against a store binding 300 pods in batches of 100:
    every bind seen on its node, in resource_version order, no error, in
    fewer messages than events."""
    import multiprocessing

    from minisched_tpu_torch.live import count_grpc_binds

    store = ObjectStore()
    store.create("Node", make_node("n1"))
    pods = [make_pod(f"c{i:03d}") for i in range(300)]
    store.create_many("Pod", pods)
    _srv, address, shutdown = start_grpc_server(store=store, device="cpu")
    ctx = multiprocessing.get_context("spawn")
    from_watcher, to_parent = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=count_grpc_binds,
                       args=(address, len(pods), to_parent, 64), daemon=True)
    proc.start()
    try:
        assert from_watcher.poll(120)
        assert from_watcher.recv()["sync"] == 0

        def bind(p):
            p.spec.node_name = "n1"
            return p

        for i in range(0, len(pods), 100):
            store.mutate_many("Pod", [(p.metadata.namespace, p.metadata.name,
                                       bind) for p in pods[i:i + 100]])
        assert from_watcher.poll(120)
        seen = from_watcher.recv()
    finally:
        proc.join(30)
        if proc.is_alive():
            proc.terminate()
        shutdown()
    assert seen["error"] is None and seen["rv_ordered"]
    assert seen["bound"] == {p.metadata.name: "n1" for p in pods}
    assert seen["events"] == len(pods)
    assert 3 <= seen["messages"] < len(pods)
