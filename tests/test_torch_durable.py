"""The port's durable store (``controlplane/durable.py``, ``checkpoint.py``,
``fsck.py``) on the CPU: against the JAX package's on the same files,
and the port's copies of JAX's ``tests/test_durable.py`` (less the
client rate-limiter tests, held in ``test_torch_main.py``) and
``tests/test_group_commit.py``, under the JAX test names.

Parity with JAX, on inputs made from a numpy seed: the checkpoint
codec's documents are byte-equal and each package decodes the other's;
a WAL and checkpoint written by one package's store open in the other's
with the same objects (Leases a ``LeaseManager`` acquired, renewed and
took over among them), resource_version, history floor, acks and
``watch(resume_rv=N)`` answers; ``fsck`` and ``repair`` give equal
reports on the same clean or damaged files; one stub fault fabric drives
both stores through degraded mode alike.  Recovery: the port's device
engine on ``device="cpu"`` recovers and goes on placing as the JAX
engine does on the same scenario; uids and the per-node aggregates
survive a reopen; a ``python -m minisched_tpu_torch`` child SIGKILLed
mid-run loses no bind its watch saw.  Every wait has a deadline; fsync
is off except where a test measures the coalescing of fsyncs.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from minisched_tpu.api import objects as jobj
from minisched_tpu.controlplane import checkpoint as jckpt
from minisched_tpu.controlplane import client as jclient
from minisched_tpu.controlplane import durable as jdurable
from minisched_tpu.controlplane import fsck as jfsck
from minisched_tpu.controlplane import store as jstore
from minisched_tpu import faults as jfaults
from minisched_tpu.ha import lease as jlease
from minisched_tpu.observability import counters as jcounters
from minisched_tpu.service import config as jconfig
from minisched_tpu.service.service import SchedulerService as JService

from minisched_tpu_torch.api import objects as tobj
from minisched_tpu_torch.api.objects import Binding, make_node, make_pod
from minisched_tpu_torch.controlplane import checkpoint as tckpt
from minisched_tpu_torch.controlplane import client as tclient
from minisched_tpu_torch.controlplane import durable as tdurable
from minisched_tpu_torch.controlplane import fsck as tfsck
from minisched_tpu_torch.controlplane import store as tstore
from minisched_tpu_torch.ha import lease as tlease
from minisched_tpu_torch.controlplane.client import (
    KIND_NODE,
    KIND_POD,
    Client,
)
from minisched_tpu_torch.controlplane.durable import (
    DurableObjectStore,
    store_from_url,
)
from minisched_tpu_torch.controlplane.store import Conflict
from minisched_tpu_torch.observability import counters, hist
from minisched_tpu_torch.service import config as tconfig
from minisched_tpu_torch.service.service import SchedulerService as TService

ROOT = Path(__file__).resolve().parents[1]

#: per package: objects, checkpoint codec, client module, durable module,
#: store module, fsck module, counters
SIDES = {
    "jax": (jobj, jckpt, jclient, jdurable, jstore, jfsck, jcounters),
    "port": (tobj, tckpt, tclient, tdurable, tstore, tfsck, counters),
}
#: per package: the lease protocol (``ha/lease.py``)
LEASES = {"jax": jlease, "port": tlease}


def wait_for(pred, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def listing(side, store):
    """Every kind both packages keep durable (Lease included), its
    objects through the package's codec, by key."""
    ckpt = SIDES[side][1]
    return {kind: sorted((o.metadata.key, ckpt._encode(o))
                         for o in store.list(kind))
            for kind in tckpt.KIND_TYPES}


# -- the checkpoint codec -------------------------------------------------------


def _seeded_objects(objs, seed):
    rng = np.random.default_rng(seed)
    nodes = [objs.make_node(
        f"n{i}", unschedulable=bool(rng.random() < 0.3),
        labels={"zone": f"z{int(rng.integers(0, 3))}"},
        capacity={"cpu": str(int(rng.integers(2, 9))), "memory": "8Gi",
                  "pods": 110},
        taints=[objs.Taint("k", "v", "NoSchedule")] if rng.random() < 0.3
        else None)
        for i in range(5)]
    pods = []
    for i in range(8):
        p = objs.make_pod(
            f"p{i}", requests={"cpu": f"{int(rng.integers(1, 9)) * 100}m",
                               "memory": "256Mi"},
            labels={"app": f"a{i % 2}"}, priority=int(rng.integers(0, 3)))
        p.metadata.uid = f"pod-{i:08d}"
        p.metadata.resource_version = i + 1
        if rng.random() < 0.5:
            p.spec.node_name = f"n{int(rng.integers(0, 5))}"
        if rng.random() < 0.3:
            p.spec.gang = objs.GangSpec(f"g{i % 2}", 2, 5.0)
        if rng.random() < 0.3:
            p.spec.tolerations = [objs.Toleration("k", "Equal", "v",
                                                  "NoSchedule")]
        pods.append(p)
    return {"Node": {n.metadata.key: n for n in nodes},
            "Pod": {p.metadata.key: p for p in pods}}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snapshot_docs_equal_and_decode_across(seed):
    """``build_snapshot_doc`` gives the same JSON in both packages for
    equal objects, and each package's ``_decode`` of the other's
    document gives objects that encode back to the same document."""
    jmaps, tmaps = _seeded_objects(jobj, seed), _seeded_objects(tobj, seed)
    jdoc = jckpt.build_snapshot_doc(jmaps, 77)
    tdoc = tckpt.build_snapshot_doc(tmaps, 77, jdoc["uid_floor"])
    assert json.dumps(tdoc) == json.dumps(jdoc)
    for kind, items in jdoc["objects"].items():
        for data in items:
            t = tckpt._decode(tckpt.KIND_TYPES[kind], data)
            j = jckpt._decode(jckpt.KIND_TYPES[kind], data)
            assert tckpt._encode(t) == data == jckpt._encode(j)
            assert type(t).__module__.startswith("minisched_tpu_torch")


# -- cross-open: one package writes, the other reads --------------------------


def _seeded_mix(side, path, seed):
    """A seeded mix on ``side``'s durable store: creates, updates,
    deletes, CAS conflicts, capacity-checked ``bind_many``, volatile
    Events, an ack record, Lease records (an acquire before the
    ``compact()`` in the middle, a renewal and a takeover after it) and
    that compaction.  Returns the checkpoint's rv and the writer's final
    listing and rv."""
    objs, _ckpt, client_mod, durable, store_mod, _f, _c = SIDES[side]
    rng = np.random.default_rng(seed)
    store = durable.DurableObjectStore(path)
    client = client_mod.Client(store=store)
    clock = [1000.0 + seed]
    leases = LEASES[side].LeaseManager(client, clock=lambda: clock[0])
    held = leases.acquire("store-leader", "r0", ttl_s=2.0)
    assert held is not None
    client.nodes().create_many([objs.make_node(
        f"n{i}", capacity={"cpu": "2", "memory": "4Gi", "pods": 110})
        for i in range(4)])
    client.pods().create_many([objs.make_pod(f"p{i:03d}",
                                             requests={"cpu": "500m"})
                               for i in range(30)])
    ckpt_rv = 0
    for step in range(60):
        if step == 30:
            store.compact()
            ckpt_rv = store.resource_version
        if step == 40:
            clock[0] += 1.0
            held = leases.renew(held, epoch=seed + 1)
        if step == 50:
            clock[0] += 5.0
            assert leases.acquire("store-leader", "r1", ttl_s=2.0)
        op = int(rng.integers(0, 6))
        name = f"p{int(rng.integers(0, 30)):03d}"
        try:
            if op == 0:
                p = store.get("Pod", "default", name)
                p.metadata.labels["step"] = str(step)
                store.update("Pod", p)
            elif op == 1:
                store.delete("Pod", "default", name)
            elif op == 2:
                p = store.get("Pod", "default", name)
                with pytest.raises(store_mod.Conflict):
                    store.update("Pod", p, expected_rv=0)
            elif op == 3:
                node = f"n{int(rng.integers(0, 4))}"
                client.pods().bind_many([
                    objs.Binding(f"p{int(k):03d}", "default", node)
                    for k in rng.integers(0, 30, 3)])
            elif op == 4:
                store.create("Event", objs.Event(metadata=objs.ObjectMeta(
                    name=f"ev{step}", namespace="default")))
            else:
                store.create("Pod", objs.make_pod(f"x{step:03d}"))
        except KeyError:
            pass  # deleted before: nothing to do
    store.record_acks({f"batch{seed}/0": {"node": "n1", "ok": True}})
    store.create("Pod", objs.make_pod("tail"))
    final = (listing(side, store), store.resource_version)
    store.close()
    return ckpt_rv, final


def _reader_view(side, path, ckpt_rv):
    store = SIDES[side][3].DurableObjectStore(path, readonly=True)
    hc = SIDES[side][4].HistoryCompacted
    resumes = {}
    for n in (ckpt_rv - 3, ckpt_rv, ckpt_rv + 5, store.resource_version,
              store.resource_version + 1):
        try:
            w, snap = store.watch("Pod", resume_rv=n)
        except hc as e:
            resumes[n] = ("410", str(e))
            continue
        evs = w.next_batch(timeout=0.5)
        w.stop()
        resumes[n] = [(ev.type.value, ev.rv,
                       SIDES[side][1]._encode(ev.obj)) for ev in evs]
    view = (listing(side, store), store.resource_version,
            store.history_floor, store.recovered_acks(), resumes,
            store.storage_stats()["ckpt_source"], store.wal_end())
    store.close()
    return view


@pytest.mark.parametrize("writer, reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("seed", [0, 1])
def test_cross_open(tmp_path, writer, reader, seed):
    """The other package opens the writer's WAL and checkpoint: the same
    objects, resource_version, history floor and acks, and the same
    answers to ``watch(resume_rv=N)`` before the checkpoint (410), after
    it (the same events) and ahead of the store (410)."""
    path = str(tmp_path / "x.wal")
    ckpt_rv, (objs, rv) = _seeded_mix(writer, path, seed)
    got = _reader_view(reader, path, ckpt_rv)
    want = _reader_view(writer, path, ckpt_rv)
    assert got == want
    assert got[0] == objs and got[1] == rv and got[2] == ckpt_rv > 0
    assert got[4][ckpt_rv - 3][0] == "410" and got[4][rv + 1][0] == "410"
    assert got[4][ckpt_rv]  # the tail's events replay
    assert got[3] == {f"batch{seed}/0": {"node": "n1", "ok": True}}
    (_key, lease), = got[0]["Lease"]
    assert lease["spec"]["holder"] == "r1"
    assert lease["spec"]["transitions"] == 1


# -- fsck and repair on the same files -----------------------------------------


def _damaged_store(writer, path, damage):
    objs, _ckpt, client_mod, durable = SIDES[writer][:4]
    store = durable.DurableObjectStore(path)
    client = client_mod.Client(store=store)
    client.nodes().create_many([objs.make_node(f"n{i}") for i in range(3)])
    client.pods().create_many([objs.make_pod(f"p{i}") for i in range(10)])
    store.compact()
    client.pods().bind_many([objs.Binding("p0", "default", "n1")])
    store.compact()  # the first generation becomes .prev
    client.pods().create_many([objs.make_pod(f"q{i}") for i in range(10)])
    client.pods().bind_many([objs.Binding("q3", "default", "n2")])
    store.close()
    if damage == "bitflip":
        data = bytearray(open(path, "rb").read())
        data[len(data) // 3] ^= 0x10
        open(path, "wb").write(bytes(data))
    elif damage == "torn_tail":
        with open(path, "ab") as f:
            f.write(tdurable.encode_frame({"op": "rv", "rv": 999})[:11])
    elif damage == "bad_digest":
        ck = path + ".ckpt"
        data = bytearray(open(ck, "rb").read())
        data[len(data) // 2] ^= 0x01
        open(ck, "wb").write(bytes(data))
    elif damage == "missing_ckpt":
        for suffix in (".ckpt", ".ckpt.sha256", ".ckpt.prev",
                       ".ckpt.prev.sha256"):
            os.unlink(path + suffix)


DAMAGES = ["clean", "bitflip", "torn_tail", "bad_digest", "missing_ckpt"]


@pytest.mark.parametrize("damage", DAMAGES)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_fsck_and_repair_reports_equal_to_jax(tmp_path, writer, damage):
    path = str(tmp_path / "f.wal")
    _damaged_store(writer, path, damage)
    report = tfsck.fsck(path)
    assert report == jfsck.fsck(path)
    assert report["ok"] == (damage in ("clean", "torn_tail",
                                       "missing_ckpt"))
    if damage == "bad_digest":
        assert report["state"]["ckpt_source"] == "prev"
    # repair writes: each package repairs its own copy of the files
    reps = {}
    for side, mod in (("jax", jfsck), ("port", tfsck)):
        d = tmp_path / side
        d.mkdir()
        for f in os.listdir(tmp_path):
            if f.startswith("f.wal"):
                shutil.copy(tmp_path / f, d / f)
        rep = mod.repair(str(d / "f.wal"))
        after = mod.fsck(str(d / "f.wal"))
        reps[side] = json.loads(json.dumps([rep, after]).replace(str(d),
                                                                   "<dir>"))
    assert reps["port"] == reps["jax"]


# -- degraded mode through one stub fault fabric -------------------------------


class StubFaults:
    """The duck-typed fault fabric both stores read: ``check`` raises at
    an armed point, ``should_fire`` answers whether a point is armed."""

    def __init__(self):
        self.armed = set()

    def check(self, point, key):
        if point in self.armed:
            raise RuntimeError(f"injected {point} on {key}")

    def should_fire(self, point, key):
        return point in self.armed


DEGRADED_COUNTERS = ("storage.degraded_enter", "storage.append_error",
                     "storage.recovery_probe", "storage.degraded_recovered")


def _degraded_run(side, path, monkeypatch, group_commit):
    objs, _ckpt, client_mod, durable, store_mod, _f, ctr = SIDES[side]
    monkeypatch.setenv("MINISCHED_GROUP_COMMIT", group_commit)
    ctr.reset()
    store = durable.DurableObjectStore(path, probe_interval_s=0.0)
    client = client_mod.Client(store=store)
    faults = store.faults = StubFaults()
    client.nodes().create(objs.make_node("n1"))
    client.pods().create(objs.make_pod("p1"))
    log = []

    def attempt(what, fn):
        before = (listing(side, store), dict(store._pod_node_agg))
        try:
            fn()
            log.append((what, "ok"))
        except Exception as e:  # noqa: BLE001 — the type is the answer
            log.append((what, type(e).__name__))
            assert (listing(side, store), dict(store._pod_node_agg)) == \
                before, f"{what} changed memory before failing"

    faults.armed = {"wal.append"}
    attempt("append refused", lambda: store.create(
        "Node", objs.make_node("n2")))
    faults.armed = {"disk.enospc"}
    attempt("enospc", lambda: store.create("Node", objs.make_node("n3")))
    log.append(("degraded", store.storage_stats()["degraded"]))
    log.append(("reads", store.get("Node", "", "n1").metadata.name))
    attempt("bind while degraded", lambda: client.pods().bind_many(
        [objs.Binding("p1", "default", "n1")]))
    attempt("probe fails", lambda: store.create("Node",
                                                objs.make_node("n4")))
    faults.armed = set()
    attempt("probe re-arms", lambda: store.create("Node",
                                                  objs.make_node("n5")))
    attempt("bind", lambda: client.pods().bind_many(
        [objs.Binding("p1", "default", "n1")]))
    stats = store.storage_stats()
    stats.pop("degraded_dwell_s")
    rv = store.resource_version
    store.close()
    re = durable.DurableObjectStore(path)
    names = sorted(n.metadata.name for n in re.list("Node"))
    bound = re.get("Pod", "default", "p1").spec.node_name
    re.close()
    return (log, stats, rv, names, bound,
            {c: ctr.get(c) for c in DEGRADED_COUNTERS})


@pytest.mark.parametrize("group_commit", ["1", "0"])
def test_degraded_mode_as_jax(tmp_path, monkeypatch, group_commit):
    """The same mutations refused before memory changes, reads serving,
    the probe re-arming writes, and equal counters, in both stores."""
    got = _degraded_run("port", str(tmp_path / "t.wal"), monkeypatch,
                        group_commit)
    want = _degraded_run("jax", str(tmp_path / "j.wal"), monkeypatch,
                         group_commit)
    assert got == want
    log = dict(got[0])
    assert log["append refused"] == "RuntimeError"
    assert log["enospc"] == "StorageDegraded" and log["degraded"] is True
    assert log["bind while degraded"] == "StorageDegraded"
    assert log["probe re-arms"] == "ok" and got[3] == ["n1", "n5"]
    assert got[4] == "n1" and all(got[5].values())


# -- recovery -------------------------------------------------------------------


def _crash_recovery(side, wal, monkeypatch):
    """The first life binds a seeded cluster with the full roster on
    ``side``'s device engine; the second reopens the WAL, holds the
    placements, keeps the queue empty and places one new pod."""
    objs, _ckpt, client_mod, durable = SIDES[side][:4]
    config, Service = ((jconfig, JService) if side == "jax"
                       else (tconfig, TService))
    monkeypatch.setenv("MINISCHED_PIPELINE", "0")
    kw = {"device": "cpu"} if side == "port" else {}
    rng = np.random.default_rng(11)
    lives = []
    for life in range(2):
        store = durable.DurableObjectStore(wal)
        client = client_mod.Client(store=store)
        if life == 0:
            client.nodes().create_many([objs.make_node(
                f"node{i}", capacity={"cpu": "2", "memory": "8Gi",
                                      "pods": 110}) for i in range(4)])
            pods = [objs.make_pod(f"pod{i}", requests={
                "cpu": f"{int(rng.choice([100, 300, 700]))}m"})
                for i in range(6)]
            for i, p in enumerate(pods):
                p.metadata.uid = f"pod-{i:08d}"
            client.pods().create_many(pods)
        recovered = {p.metadata.name: p.spec.node_name
                     for p in client.pods().list()}
        svc = Service(client)
        sched = svc.start_scheduler(
            config.default_full_roster_config(time_scale=0.01),
            device_mode=True, max_wave=16, **kw)
        try:
            if life == 1:
                time.sleep(0.5)
                stats = sched.queue.stats()
                assert stats["active"] == stats["backoff"] == \
                    stats["unschedulable"] == 0, stats
                new = objs.make_pod("pod9", requests={"cpu": "100m"})
                new.metadata.uid = "pod-00000009"
                client.pods().create(new)
            assert wait_for(lambda: all(p.spec.node_name
                                        for p in client.pods().list()))
            lives.append((recovered, {p.metadata.name: p.spec.node_name
                                      for p in client.pods().list()}))
        finally:
            svc.close()
            store.close()
    return lives


def test_crash_recovery_resumes_scheduling(tmp_path, monkeypatch):
    """The etcd-replacement story end to end, on the port's device engine
    (``device="cpu"``): the recovered placements equal the first life's,
    the replayed informers requeue nothing, a new pod binds, old
    placements stay, and both lives place as the JAX engine does."""
    got = _crash_recovery("port", str(tmp_path / "t.wal"), monkeypatch)
    (_, first), (recovered, second) = got
    assert recovered == first and len(first) == 6
    assert second["pod9"] and {k: second[k] for k in first} == first
    assert got == _crash_recovery("jax", str(tmp_path / "j.wal"),
                                  monkeypatch)


def test_uid_floor_survives_reopen_and_compaction(tmp_path):
    """A pod created after recovery gets a uid past every recovered one,
    also past a deleted pod's whose put record compaction dropped (the
    checkpoint's ``uid_floor``)."""
    path = str(tmp_path / "u.wal")
    store = DurableObjectStore(path)
    uids = [store.create("Pod", make_pod(f"p{i}")).metadata.uid
            for i in range(5)]
    store.delete("Pod", "default", "p4")
    store.close()
    re = DurableObjectStore(path)
    fresh = re.create("Pod", make_pod("after-wal")).metadata.uid
    assert fresh not in uids and tdurable._uid_suffix(fresh) == 6
    re.delete("Pod", "default", "after-wal")
    re.compact()  # the deleted pod's put record is gone now
    re.close()
    with open(path + ".ckpt") as f:
        assert json.load(f)["uid_floor"] == 6
    re2 = DurableObjectStore(path)
    assert tdurable._uid_suffix(
        re2.create("Pod", make_pod("after-ckpt")).metadata.uid) == 7
    re2.close()


@pytest.mark.parametrize("compact", [False, True])
def test_bind_capacity_after_reopen_equals_live_store(tmp_path, compact):
    """The per-node aggregates are rebuilt at replay: ``bind_many``'s
    capacity answers after a reopen equal those of a store that never
    closed (no overcommit after a restart)."""
    def first(store):
        client = Client(store=store)
        client.nodes().create_many([make_node(
            f"n{i}", capacity={"cpu": "1", "memory": "4Gi", "pods": 110})
            for i in range(2)])
        client.pods().create_many([make_pod(f"p{i}", requests={
            "cpu": "600m"}) for i in range(4)])
        client.pods().bind_many([Binding("p0", "default", "n0")])
        if compact:
            store.compact()
        return client

    def second(client):
        out = client.pods().bind_many([Binding("p1", "default", "n0"),
                                       Binding("p2", "default", "n1"),
                                       Binding("p3", "default", "n1")],
                                      return_objects=False)
        return [type(r).__name__ for r in out], dict(
            client.store._pod_node_agg)

    live = first(DurableObjectStore(str(tmp_path / "live.wal")))
    want = second(live)
    first(DurableObjectStore(str(tmp_path / "re.wal"))).store.close()
    re = DurableObjectStore(str(tmp_path / "re.wal"))
    assert second(Client(store=re)) == want
    assert want[0] == ["OutOfCapacity", "NoneType", "OutOfCapacity"]
    re.close()


def test_child_process_sigkilled_mid_run_loses_no_watched_bind(tmp_path):
    """Chip smoke phase 29's flow (``live.run_config5_durable``) at 100
    nodes and 1,000 pods: ``python -m minisched_tpu_torch`` on the scalar
    engine over a ``file://`` store, fed over HTTP and SIGKILLed once its
    watch has seen binds; then the device engine on ``device="cpu"``
    recovers the store in this process.  Every created pod and every bind
    the watch saw is in the recovered store, on the same node; the rest
    of the plain pods bound and no ``special*`` pod; the audit clean;
    compaction and a read-only reopen equal; ``fsck`` exits 0."""
    from minisched_tpu_torch.live import run_config5_durable

    run = run_config5_durable(
        str(tmp_path), n_nodes=100, n_pods=1_000, kill_binds=20,
        device="cpu", chunk=250, timeout_s=120.0,
        child_env={"MINISCHED_DEVICE_MODE": "0", "PYTHONPATH": str(ROOT)})
    assert run.n_plain == 980 and run.seen_at_kill >= 20
    assert run.left_at_boot >= 98  # the kill landed mid-run
    assert run.waves >= 1 and run.loop_errors == 0
    assert run.assumed_left == 0 and run.waiting_left == 0
    assert run.audit["nodes"] == 100 and run.audit["bound"] == 980
    assert run.wal_records > 1_100 and run.wal_bytes > 0
    assert run.fsck_rc == 0 and run.fsck_objects["Pod"] == 1_000
    assert run.threads_left == []


# -- the port's copies of tests/test_durable.py ---------------------------------


def test_wal_survives_reopen(tmp_path):
    path = str(tmp_path / "store.wal")
    store = DurableObjectStore(path)
    store.create(KIND_NODE, make_node("n1"))
    store.create(KIND_POD, make_pod("p1"))
    store.create(KIND_POD, make_pod("p2"))
    p1 = store.get(KIND_POD, "default", "p1")
    p1.spec.node_name = "n1"
    store.update(KIND_POD, p1)
    store.delete(KIND_POD, "default", "p2")
    rv = store.resource_version
    store.close()

    re = DurableObjectStore(path)
    assert {n.metadata.name for n in re.list(KIND_NODE)} == {"n1"}
    pods = re.list(KIND_POD)
    assert [p.metadata.name for p in pods] == ["p1"]
    assert pods[0].spec.node_name == "n1"
    assert pods[0].metadata.uid == p1.metadata.uid
    assert re.resource_version == rv


def test_wal_tolerates_torn_tail(tmp_path):
    path = str(tmp_path / "store.wal")
    store = DurableObjectStore(path)
    store.create(KIND_NODE, make_node("n1"))
    store.close()
    with open(path, "a") as f:
        f.write('{"op": "put", "kind": "Node", "obj": {"trunc')
    re = DurableObjectStore(path)
    assert [n.metadata.name for n in re.list(KIND_NODE)] == ["n1"]


def test_compaction_shrinks_and_preserves(tmp_path):
    path = str(tmp_path / "store.wal")
    store = DurableObjectStore(path)
    node = store.create(KIND_NODE, make_node("n1"))
    for i in range(50):
        node.metadata.labels["rev"] = str(i)
        node = store.update(KIND_NODE, node)
    big = os.path.getsize(path)
    store.compact()
    assert os.path.getsize(path) < big
    rv = store.resource_version
    store.close()
    re = DurableObjectStore(path)
    assert re.get(KIND_NODE, "", "n1").metadata.labels["rev"] == "49"
    assert re.resource_version == rv
    # and the log keeps appending after compaction
    re.create(KIND_POD, make_pod("p"))
    re.close()
    assert [p.metadata.name
            for p in DurableObjectStore(path).list(KIND_POD)] == ["p"]


def test_store_from_url(tmp_path):
    assert store_from_url("") is None
    s = store_from_url(f"file://{tmp_path}/x.wal")
    assert isinstance(s, DurableObjectStore)
    with pytest.raises(ValueError):
        store_from_url("etcd://nope")


def test_scheduler_runs_on_durable_store(tmp_path):
    """The storage boundary is real: the live engine (the device engine,
    the CPU twins) runs unchanged on the WAL backend, and the bind
    survives a store reopen."""
    path = str(tmp_path / "cluster.wal")
    client = Client(store=DurableObjectStore(path))
    svc = TService(client)
    svc.start_scheduler(tconfig.default_scheduler_config(time_scale=0.01),
                        device="cpu")
    try:
        client.nodes().create(make_node("node1"))
        client.pods().create(make_pod("pod1"))
        assert wait_for(lambda: client.pods().get("pod1").spec.node_name,
                        10)
        assert client.pods().get("pod1").spec.node_name == "node1"
    finally:
        svc.close()
        client.store.close()
    re = DurableObjectStore(path)
    assert re.get(KIND_POD, "default", "pod1").spec.node_name == "node1"


def test_torn_tail_is_truncated_and_next_append_survives(tmp_path):
    """A write after a torn tail must not concatenate onto the garbage
    (which lost the acknowledged write on the NEXT reopen)."""
    path = str(tmp_path / "store.wal")
    store = DurableObjectStore(path)
    store.create(KIND_NODE, make_node("n1"))
    store.close()
    with open(path, "a") as f:
        f.write('{"op": "put", "kind": "Node", "obj": {"trunc')
    re1 = DurableObjectStore(path)
    re1.create(KIND_NODE, make_node("n2"))  # lands after the truncation
    re1.close()
    re2 = DurableObjectStore(path)
    assert {n.metadata.name for n in re2.list(KIND_NODE)} == {"n1", "n2"}


def test_rv_watermark_survives_reopen(tmp_path):
    path = str(tmp_path / "store.wal")
    store = DurableObjectStore(path)
    store.create(KIND_NODE, make_node("n1"))
    store.set_resource_version(500)
    store.close()
    assert DurableObjectStore(path).resource_version == 500


def test_volatile_kinds_not_logged(tmp_path):
    """Events (and other non-checkpoint kinds) stay in-memory; the WAL
    must reopen cleanly after recording one."""
    path = str(tmp_path / "store.wal")
    store = DurableObjectStore(path)

    class _Ev:
        kind = "Event"

        def __init__(self):
            self.metadata = tobj.ObjectMeta(name="ev1")

        def clone(self):
            import copy

            return copy.deepcopy(self)

    store.create("Event", _Ev())
    store.create(KIND_NODE, make_node("n1"))
    store.close()
    re = DurableObjectStore(path)
    assert [n.metadata.name for n in re.list(KIND_NODE)] == ["n1"]
    assert re.list("Event") == []  # volatile


def test_post_close_mutation_refused(tmp_path):
    """A closed WAL store must refuse writes — a silently-dropped record
    would ACK a mutation the reopened store has never seen."""
    store = DurableObjectStore(str(tmp_path / "wal"))
    store.create("Node", make_node("n1"))
    store.close()
    with pytest.raises(RuntimeError, match="closed"):
        store.create("Node", make_node("n2"))
    # reopen: only the pre-close write is there
    store2 = DurableObjectStore(str(tmp_path / "wal"))
    assert [n.metadata.name for n in store2.list("Node")] == ["n1"]


def test_replay_rv_is_exact_when_last_record_is_rv_op(tmp_path):
    """The replayed version counter must be EXACT, not merely monotone:
    a WAL whose last record is a bare ``rv`` op reopens to exactly that
    counter, and the next mutation stamps exactly its successor."""
    from minisched_tpu_torch.controlplane.walio import (
        iter_wal_records_lenient,
    )

    path = str(tmp_path / "store.wal")
    store = DurableObjectStore(path)
    store.create(KIND_NODE, make_node("n1"))
    store.set_resource_version(7)
    store.close()
    last = list(iter_wal_records_lenient(path))[-1]
    assert last == {"op": "rv", "rv": 7}
    re = DurableObjectStore(path)
    assert re.resource_version == 7  # exact, not just >= the object rvs
    out = re.create(KIND_NODE, make_node("n2"))
    assert out.metadata.resource_version == 8
    re.close()


def test_volatile_mutations_keep_replayed_rv_exact(tmp_path):
    """Event (volatile) mutations bump the global counter with no put/del
    record; the rv watermark records keep a reopened store from
    re-issuing resource_versions watchers already observed."""
    path = str(tmp_path / "store.wal")
    store = DurableObjectStore(path)
    store.create(KIND_NODE, make_node("n1"))
    for i in range(3):
        store.create("Event", tobj.Event(metadata=tobj.ObjectMeta(
            name=f"ev{i}", namespace="default")))
    store.delete("Event", "default", "ev0")
    rv = store.resource_version
    store.close()
    re = DurableObjectStore(path)
    assert re.resource_version == rv, (
        "volatile-kind bumps lost at replay: reopened store would "
        "re-issue observed resource_versions")
    re.close()


def test_checkpoint_compaction_tail_replay_and_history_floor(tmp_path):
    """compact() = snapshot (<wal>.ckpt) + truncate: recovery is
    checkpoint ⊕ WAL tail; a pre-checkpoint delete whose put record
    survives in an overlapping WAL must NOT resurrect; the reopened
    store's history floor sits at the checkpoint rv (watch resumes from
    before it get 410)."""
    from minisched_tpu_torch.controlplane.store import HistoryCompacted

    path = str(tmp_path / "store.wal")
    store = DurableObjectStore(path)
    store.create(KIND_NODE, make_node("gone"))
    store.delete(KIND_NODE, "", "gone")
    store.create(KIND_NODE, make_node("kept"))
    store.compact()
    assert os.path.exists(path + ".ckpt")
    assert os.path.getsize(path) == 0  # tail truncated
    ckpt_rv = store.resource_version
    store.create(KIND_POD, make_pod("tail-pod"))  # the WAL tail
    rv = store.resource_version
    store.close()

    re = DurableObjectStore(path)
    assert {n.metadata.name for n in re.list(KIND_NODE)} == {"kept"}
    assert [p.metadata.name for p in re.list(KIND_POD)] == ["tail-pod"]
    assert re.resource_version == rv
    assert re.history_floor == ckpt_rv
    # tail events are resumable; pre-checkpoint ones are 410
    w, snap = re.watch(KIND_POD, resume_rv=ckpt_rv)
    ev = w.next(timeout=1.0)
    assert ev is not None and ev.obj.metadata.name == "tail-pod"
    w.stop()
    with pytest.raises(HistoryCompacted):
        re.watch(KIND_POD, resume_rv=ckpt_rv - 1)
    re.close()


def test_crash_between_checkpoint_and_truncate_does_not_resurrect(tmp_path):
    """The overlap window compact() is built to survive: checkpoint
    written, WAL NOT yet truncated (crash in between).  Replay must skip
    the pre-snapshot records."""
    path = str(tmp_path / "store.wal")
    store = DurableObjectStore(path)
    store.create(KIND_NODE, make_node("ghost"))
    store.delete(KIND_NODE, "", "ghost")
    store.create(KIND_NODE, make_node("real"))
    with open(path, "rb") as f:
        old_records = f.read()
    store.compact()
    store.close()
    with open(path, "rb") as f:
        tail = f.read()
    with open(path, "wb") as f:
        f.write(old_records + tail)
    re = DurableObjectStore(path)
    assert {n.metadata.name for n in re.list(KIND_NODE)} == {"real"}, (
        "pre-checkpoint put resurrected a deleted object")
    re.close()


def test_compaction_archives_history_for_the_audit(tmp_path):
    """archive_compacted: truncated segments append to <wal>.history so
    wal_double_binds audits the FULL mutation history across
    compactions."""
    from minisched_tpu_torch.controlplane.fsck import wal_double_binds

    path = str(tmp_path / "store.wal")
    store = DurableObjectStore(path, archive_compacted=True)
    store.create(KIND_NODE, make_node("n1"))
    p = store.create(KIND_POD, make_pod("p1"))
    p.spec.node_name = "n1"
    store.update(KIND_POD, p)
    store.compact()  # bind record now lives only in .history
    store.create(KIND_POD, make_pod("p2"))
    store.close()
    assert wal_double_binds(path) == []
    store2 = DurableObjectStore(path, archive_compacted=True)
    cur = store2.get(KIND_POD, "default", "p1")
    cur.spec.node_name = "n2"
    store2.update(KIND_POD, cur)
    store2.close()
    violations = wal_double_binds(path)
    assert len(violations) == 1 and violations[0][1:] == ("n1", "n2")
    assert violations == jfaults.wal_double_binds(path)


def test_checkpoint_snapshot_under_concurrent_writes_round_trips(tmp_path):
    """compact() taken MID-WAVE while writer threads hammer binds stays a
    consistent cut: on reopen the store equals the writer's final state,
    object for object and counter-exact."""
    path = str(tmp_path / "store.wal")
    store = DurableObjectStore(path)
    client = Client(store=store)
    n_nodes, n_pods = 4, 120
    for i in range(n_nodes):
        client.nodes().create(make_node(f"n{i}"))
    for i in range(n_pods):
        client.pods().create(make_pod(f"p{i:03d}"))

    stop = threading.Event()
    errs: list = []

    def binder():
        try:
            for start in range(0, n_pods, 10):
                client.pods().bind_many([
                    Binding(f"p{i:03d}", "default", f"n{i % n_nodes}")
                    for i in range(start, start + 10)])
        except Exception as e:  # pragma: no cover - failure evidence
            errs.append(e)
        finally:
            stop.set()

    def compactor():
        while not stop.is_set():
            store.compact()

    threads = [threading.Thread(target=binder),
               threading.Thread(target=compactor)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errs, errs
    expect = {p.metadata.name: (p.spec.node_name,
                                p.metadata.resource_version, p.metadata.uid)
              for p in store.list(KIND_POD)}
    rv = store.resource_version
    store.close()

    re = DurableObjectStore(path)
    got = {p.metadata.name: (p.spec.node_name,
                             p.metadata.resource_version, p.metadata.uid)
           for p in re.list(KIND_POD)}
    assert got == expect
    assert re.resource_version == rv
    assert all(node for node, _, _ in got.values())  # every bind recovered
    re.close()


def test_back_to_back_compaction_pauses_for_writers(tmp_path, monkeypatch):
    """The port's own fairness rule: a compaction called sooner after the
    last one ended than that one took sleeps out the rest first (JAX's
    store has no pause, and a compaction loop starves its writers:
    ``tests/compact_fairness.py``)."""
    store = DurableObjectStore(str(tmp_path / "store.wal"))
    store.create(KIND_NODE, make_node("n1"))
    slept = []
    monkeypatch.setattr(tdurable.time, "sleep", slept.append)
    t0 = time.monotonic()
    store.compact()
    assert slept == []  # the first compaction does not wait
    end, took = store._last_compact
    assert t0 <= end - took and 0 < took <= time.monotonic() - t0
    # one that took 5 s and ended just now: the next waits nearly 5 s
    store._last_compact = (time.monotonic(), 5.0)
    store.compact()
    assert len(slept) == 1 and 4.0 < slept[0] <= 5.0
    store._last_compact = (time.monotonic() - 10.0, 1.0)
    store.compact()  # the last one ended long ago: no pause
    assert len(slept) == 1
    store.close()


def test_interrupted_archive_is_drained_exactly_once(tmp_path):
    """compact()'s archive claims the retired segment by ATOMIC RENAME
    before copying it to <wal>.history.  A SIGKILL between the two leaves
    <wal>.pending-archive; the next open folds it in exactly once."""
    from minisched_tpu_torch.controlplane.walio import (
        iter_wal_records_lenient,
    )

    path = str(tmp_path / "store.wal")
    store = DurableObjectStore(path, archive_compacted=True)
    store.create(KIND_NODE, make_node("n1"))
    # the kill window: checkpoint + rename land, the history copy doesn't
    store._drain_pending_archive = lambda: None
    store.compact()
    del store._drain_pending_archive  # back to the class implementation
    store.create(KIND_NODE, make_node("n2"))  # WAL tail after the "crash"
    store.close()
    assert os.path.exists(path + ".pending-archive")

    re = DurableObjectStore(path, archive_compacted=True)
    assert not os.path.exists(path + ".pending-archive")  # drained at open
    assert {n.metadata.name for n in re.list(KIND_NODE)} == {"n1", "n2"}
    re.compact()  # and a later compaction must not re-archive n1's record
    re.close()

    def archived(name):
        return sum(1 for rec in iter_wal_records_lenient(path + ".history")
                   if rec.get("op") == "put"
                   and rec["obj"]["metadata"]["name"] == name)

    assert archived("n1") == 1  # exactly once, across crash + 2 compactions
    assert archived("n2") == 1


# -- the port's copies of tests/test_group_commit.py ----------------------------

N_WRITERS = 8
PER_WRITER = 25


def _concurrent_creates(store, n_writers=N_WRITERS, per=PER_WRITER):
    gate = threading.Barrier(n_writers)
    errs: list = []

    def worker(w: int) -> None:
        try:
            gate.wait()
            for i in range(per):
                store.create("Pod", make_pod(f"p{w:02d}-{i:03d}"))
        except BaseException as e:  # pragma: no cover - surfaced below
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(n_writers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs
    return n_writers * per


def test_concurrent_creates_coalesce_and_replay(tmp_path):
    """Concurrent singleton mutations share barriers (groups < records,
    fsyncs saved), every ack is durable (reopen agrees exactly), and the
    rv sequence is dense — the WAL byte order IS the rv order."""
    path = str(tmp_path / "gc.wal")
    store = DurableObjectStore(path, fsync=True)
    counters.reset()
    n = _concurrent_creates(store)
    assert counters.get("storage.group_commit.records") == n
    groups = counters.get("storage.group_commit.groups")
    assert 0 < groups < n, f"no coalescing: {groups} groups for {n}"
    assert counters.get("storage.group_commit.fsyncs_saved") == n - groups
    rvs = sorted(p.metadata.resource_version for p in store.list("Pod"))
    assert rvs == list(range(1, n + 1))
    store.close()
    re = DurableObjectStore(path)
    assert len(re.list("Pod")) == n
    assert re.resource_version == n
    re.close()


def test_kill_switch_restores_per_mutation_path(tmp_path, monkeypatch):
    """MINISCHED_GROUP_COMMIT=0 is the exact pre-pipeline path: no group
    counters move, no staging structures fill, and the same workload
    produces the same replayable state."""
    monkeypatch.setenv("MINISCHED_GROUP_COMMIT", "0")
    path = str(tmp_path / "off.wal")
    store = DurableObjectStore(path, fsync=True)
    assert not store._gc_enabled
    counters.reset()
    n = _concurrent_creates(store)
    assert counters.get("storage.group_commit.groups") == 0
    assert counters.get("storage.group_commit.records") == 0
    assert not store._gc_stage and not store._gc_pending
    rvs = sorted(p.metadata.resource_version for p in store.list("Pod"))
    assert rvs == list(range(1, n + 1))
    store.close()
    re = DurableObjectStore(path)
    assert len(re.list("Pod")) == n
    re.close()


def test_watch_fanout_order_matches_rv_order(tmp_path):
    """Fanout happens at group PUBLISH, in strict rv order: a watcher
    opened before a concurrent burst sees every event exactly once, rvs
    strictly ascending."""
    store = DurableObjectStore(str(tmp_path / "w.wal"))
    w, _snap = store.watch("Pod", send_initial=False)
    n = _concurrent_creates(store, n_writers=6, per=20)
    got: list = []
    while len(got) < n:
        ev = w.next(timeout=5.0)
        assert ev is not None, f"watch starved at {len(got)}/{n}"
        got.append(ev.rv)
    assert got == sorted(got)
    assert got == list(range(1, n + 1))
    w.stop()
    store.close()


def test_visible_rv_lags_reservations(tmp_path):
    """list_with_rv and watch snapshots stamp the PUBLISHED rv, never a
    reserved-but-unwritten one — after quiesce the two agree."""
    store = DurableObjectStore(str(tmp_path / "v.wal"))
    _concurrent_creates(store, n_writers=4, per=10)
    objs, rv = store.list_with_rv("Pod")
    assert rv == store.resource_version == 40
    assert len(objs) == 40
    w, snap = store.watch("Pod")
    assert len(snap) == 40
    assert w.start_rv == rv  # nothing promised that was not delivered
    w.stop()
    store.close()


def test_expected_rv_cas_decided_at_reservation(tmp_path):
    """CAS conflicts are decided under the reservation lock, not at the
    barrier: of N concurrent updates against the same expected_rv,
    exactly one wins — the rest get a typed Conflict."""
    store = DurableObjectStore(str(tmp_path / "cas.wal"))
    pod = store.create("Pod", make_pod("contested"))
    n_w = 8
    results: list = [None] * n_w
    gate = threading.Barrier(n_w)

    def worker(i: int) -> None:
        work = pod.clone()
        work.metadata.labels = {"winner": str(i)}
        try:
            gate.wait()
            results[i] = store.update(
                "Pod", work, expected_rv=pod.metadata.resource_version)
        except Conflict as e:
            results[i] = e

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_w)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    winners = [r for r in results if not isinstance(r, Conflict)]
    assert len(winners) == 1, results
    final = store.get("Pod", "default", "contested")
    assert final.metadata.labels == winners[0].metadata.labels
    assert final.metadata.resource_version == 2
    store.close()


def test_mixed_ops_one_store_stay_ordered(tmp_path):
    """Creates, RMW mutates and deletes interleaved across threads all
    ride the same barrier machinery and replay to the same state."""
    path = str(tmp_path / "mix.wal")
    store = DurableObjectStore(path, fsync=True)
    store.create("Node", make_node("n1"))
    for i in range(8):
        store.create("Pod", make_pod(f"base-{i}"))
    gate = threading.Barrier(3)
    errs: list = []

    def creates() -> None:
        gate.wait()
        for i in range(20):
            store.create("Pod", make_pod(f"extra-{i}"))

    def mutates() -> None:
        gate.wait()
        # base-4..7 only: base-0..3 are the delete thread's victims
        for i in range(20):
            def fn(p, i=i):
                p.metadata.labels = {"round": str(i)}
                return p
            store.mutate("Pod", "default", f"base-{4 + i % 4}", fn)

    def deletes() -> None:
        gate.wait()
        for i in range(4):
            store.delete("Pod", "default", f"base-{i}")

    def run(f) -> None:
        try:
            f()
        except BaseException as e:  # pragma: no cover - surfaced below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(f,))
               for f in (creates, mutates, deletes)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs
    state = {p.metadata.name: (p.metadata.resource_version,
                               dict(p.metadata.labels or {}))
             for p in store.list("Pod")}
    store.close()
    re = DurableObjectStore(path)
    assert {p.metadata.name: (p.metadata.resource_version,
                              dict(p.metadata.labels or {}))
            for p in re.list("Pod")} == state
    re.close()


def test_group_wait_histogram_carries_exemplar(tmp_path):
    """Every waiter observes storage.group_wait_s with its object key as
    the exemplar — the p99 bucket names a pod, straight off /metrics."""
    hist.reset()
    store = DurableObjectStore(str(tmp_path / "h.wal"), fsync=True)
    n = _concurrent_creates(store, n_writers=4, per=5)
    store.close()
    child = hist.GLOBAL.get("storage.group_wait_s")
    assert child is not None and child.count == n
    assert child.exemplars, "no exemplar stamped on any bucket"
    keys = {key for key, _v in child.exemplars.values()}
    assert any(k.startswith("default/p") for k in keys), keys
    text = hist.render_prometheus(counters.Counters(), hist.GLOBAL)
    exs = hist.parse_exemplars(text)
    assert any(name == "storage_group_wait_seconds_bucket"
               and ex.get("key", "").startswith("default/p")
               for name, _labels, ex, _v in exs), text
    hist.reset()


def test_single_threaded_caller_self_elects(tmp_path):
    """No concurrency → every mutation leads its own group of one; the
    sequential semantics (and errors) are exactly the old path's."""
    store = DurableObjectStore(str(tmp_path / "s.wal"))
    counters.reset()
    store.create("Pod", make_pod("solo"))
    with pytest.raises(KeyError):
        store.get("Pod", "default", "missing")
    with pytest.raises(KeyError):
        store.delete("Pod", "default", "missing")
    with pytest.raises(Conflict):
        obj = store.get("Pod", "default", "solo").clone()
        store.update("Pod", obj, expected_rv=99)
    assert counters.get("storage.group_commit.groups") == 1
    assert counters.get("storage.group_commit.records") == 1
    assert counters.get("storage.group_commit.fsyncs_saved") == 0
    store.close()


def test_http_batch_bind_acks_survive_restart(tmp_path):
    """The façade writes each batch bind's ack outcomes to the WAL and a
    restarted façade seeds its registry from them: the retried batch
    answers ``acked`` from the recovered outcomes."""
    from minisched_tpu_torch.controlplane.httpserver import start_api_server

    path = str(tmp_path / "acks.wal")
    body = json.dumps({"batch_id": "b1", "items": [
        {"name": "p0", "namespace": "default", "node_name": "n0"}]}).encode()

    def post(base):
        req = urllib.request.Request(base + "/api/v1/bindings", data=body,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            return json.load(r)["items"][0]

    answers = []
    for life in range(2):
        store = DurableObjectStore(path)
        if life == 0:
            Client(store=store).nodes().create(make_node("n0"))
            Client(store=store).pods().create(make_pod("p0"))
        _server, base, shutdown = start_api_server(store)
        try:
            answers.append(post(base))
        finally:
            shutdown()
            store.close()
    assert not answers[0].get("acked") and answers[1]["acked"] is True
    re = DurableObjectStore(path)
    assert list(re.recovered_acks()) == ["b1/0"]
    assert re.get("Pod", "default", "p0").spec.node_name == "n0"
    re.close()
