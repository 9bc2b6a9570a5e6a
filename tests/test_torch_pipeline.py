"""The two-stage wave pipeline, re-arbitration, the cached node-table
builder and the cache's dirty tracking, against the JAX package on the
CPU.

Ports ``tests/test_wave_pipeline.py``: pipelined placements equal serial
ones for a chain that does not depend on binds (and the JAX pipelined
engine's); an overcommitting burst never overcommits; a wave built from a
stale snapshot is re-arbitrated; the re-arbitration rule itself; the
incremental aggregate base equals a full build and the JAX builder; and
the cache's dirty sets equal the JAX cache's on the same events.  Also
the port's own guarantees: a build that fails goes back raw to the serial
path, an error outside a build is counted in ``loop_errors``, and a stop
parks what the worker had popped.  Exact comparisons throughout; every
wait has a deadline and every service shuts down in a ``finally``.
"""

from __future__ import annotations

import threading

import numpy as np

from minisched_tpu_torch.api import objects as tobj
from minisched_tpu_torch.controlplane.client import Client as TClient
from minisched_tpu_torch.controlplane.informer import SharedInformerFactory
from minisched_tpu_torch.engine.device_scheduler import new_device_scheduler
from minisched_tpu_torch.engine.pipeline import WavePipeline
from minisched_tpu_torch.framework.nodeinfo import build_node_infos
from minisched_tpu_torch.models import tables as ttables
from minisched_tpu_torch.observability import counters
from minisched_tpu_torch.service import config as tconfig
from minisched_tpu_torch.service.service import SchedulerService as TService
from tests.test_torch_engine import frozen, wait_for, with_uids
from tests.test_torch_tables import assert_tables_equal


def bound_count(client):
    return sum(1 for p in client.pods().list() if p.spec.node_name)


def _nodenumber_run(side, monkeypatch, pipeline):
    """48 bind-independent pods (NodeNumber) over 10 nodes created while
    the engine runs: ({pod: node}, bind decisions)."""
    if side == "port":
        objs, config, Client, Service = tobj, tconfig, TClient, TService
        kw = {"device": "cpu", "pipeline": pipeline}
    else:
        from minisched_tpu.api import objects as objs
        from minisched_tpu.controlplane.client import Client
        from minisched_tpu.service import config
        from minisched_tpu.service.service import SchedulerService as Service

        monkeypatch.setenv("MINISCHED_PIPELINE", "1" if pipeline else "0")
        kw = {}
    binds, mu = [], threading.Lock()

    def on_decision(pod, node_name, status):
        if node_name:
            with mu:
                binds.append(pod.metadata.name)

    client = Client()
    svc = Service(client)
    try:
        sched = svc.start_scheduler(
            config.default_scheduler_config(time_scale=0.1), device_mode=True,
            max_wave=16, on_decision=on_decision, **kw)
        assert sched.pipeline_enabled == pipeline
        for i in range(10):
            client.nodes().create(objs.make_node(f"node{i}"))
        client.pods().create_many(
            with_uids([objs.make_pod(f"pp{i:03d}") for i in range(48)]))
        assert wait_for(lambda: bound_count(client) == 48)
        got = {p.metadata.name: p.spec.node_name for p in client.pods().list()}
        if side == "port":
            assert sched.loop_errors == 0
    finally:
        svc.close()
    with mu:
        return got, list(binds)


def test_pipelined_vs_serial_parity(monkeypatch):
    """``tests/test_wave_pipeline.py:86``: with NodeNumber the pipelined
    engine places every pod where the serial one does (wave compositions
    may differ, placements may not), as the JAX pipelined engine does, and
    every pod is bound exactly once."""
    serial, serial_binds = _nodenumber_run("port", monkeypatch, False)
    piped, piped_binds = _nodenumber_run("port", monkeypatch, True)
    jax_piped, _ = _nodenumber_run("jax", monkeypatch, True)
    assert serial == piped == jax_piped
    assert sorted(serial_binds) == sorted(set(serial_binds))
    assert sorted(piped_binds) == sorted(set(piped_binds))
    assert len(piped_binds) == 48


def test_pipelined_overcommit_burst_never_overcommits():
    """``:102``: 8 pods of 1 CPU into 2 nodes of 2 CPU through overlapped
    waves of 4: exactly 4 bind, the rest park, no node over allocatable —
    later waves were built from snapshots the earlier ones staled."""
    client = TClient()
    svc = TService(client)
    try:
        sched = svc.start_scheduler(
            tconfig.default_full_roster_config(time_scale=0.01),
            device_mode=True, max_wave=4, device="cpu", pipeline=True)
        for i in range(2):
            client.nodes().create(tobj.make_node(
                f"n{i}", capacity={"cpu": "2", "memory": "8Gi", "pods": 110}))
        client.pods().create_many(
            [tobj.make_pod(f"op{i}", requests={"cpu": "1"})
             for i in range(8)])
        assert wait_for(lambda: bound_count(client) == 4
                        and sched.queue.stats()["unschedulable"] == 4)
        per_node = {}
        for p in client.pods().list():
            if p.spec.node_name:
                per_node[p.spec.node_name] = (
                    per_node.get(p.spec.node_name, 0)
                    + p.resource_requests().milli_cpu)
        assert all(v <= 2000 for v in per_node.values()), per_node
        assert sched.loop_errors == 0
    finally:
        svc.close()


def _engine(client, max_wave=8, cfg=None):
    factory = SharedInformerFactory(client.store)
    sched = new_device_scheduler(
        client, factory, cfg or tconfig.default_full_roster_config(
            time_scale=0.01), max_wave=max_wave, device="cpu", pipeline=True)
    factory.start()
    assert factory.wait_for_cache_sync()
    return factory, sched


def test_stale_prepared_wave_rearbitrates():
    """``:147``: wave N+1 built by hand from a snapshot taken before wave N
    commits; run after wave N's commit, its winner is rejected at
    re-arbitration (the capacity is gone) and requeued, not double-booked
    — and its tables were copied to the device only on this thread."""
    counters.reset()
    client = TClient()
    factory, sched = _engine(client)
    try:
        client.nodes().create(tobj.make_node(
            "n1", capacity={"cpu": "1", "memory": "4Gi", "pods": 10}))
        assert wait_for(lambda: len(sched.cache.snapshot()) == 1)
        client.pods().create(tobj.make_pod("pa", requests={"cpu": "800m"}))
        client.pods().create(tobj.make_pod("pb", requests={"cpu": "800m"}))
        qpis = []

        def drained():
            qpis.extend(sched.queue.pop_batch(8, timeout=0.2))
            return len(qpis) == 2

        assert wait_for(drained, timeout=30.0)
        qa = next(q for q in qpis if q.pod.metadata.name == "pa")
        qb = next(q for q in qpis if q.pod.metadata.name == "pb")
        prepared = WavePipeline(sched)._build([qb])
        node_host, node_names, _, _ = prepared.tables
        assert node_names == ["n1"]
        assert isinstance(node_host, ttables.NodeTableHost)
        sched.schedule_wave([qa])
        assert wait_for(lambda: client.pods().get("pa").spec.node_name == "n1")
        sched._run_prepared_wave(prepared)
        assert client.pods().get("pb").spec.node_name == ""
        assert counters.get("wave_pipeline.rearb_requeued") >= 1
        assert sched.queue.stats()["active"] >= 1
    finally:
        sched.stop()
        factory.shutdown()


def test_rearbitration_unit():
    """``:207``: an assumed pod eats half a node; winners that still fit
    keep their slot and debit it for later winners of the same wave; a
    gang hit by a rejection is released whole; a chain without
    NodeResourcesFit never re-arbitrates."""
    client = TClient()
    factory, sched = _engine(client)
    try:
        client.nodes().create(tobj.make_node(
            "n1", capacity={"cpu": "2", "memory": "8Gi", "pods": 10}))
        assert wait_for(lambda: len(sched.cache.snapshot()) == 1)
        taken = tobj.make_pod("taken", requests={"cpu": "1"})
        taken.metadata.uid = "uid-taken"
        sched._assume(taken, "n1")

        def win(name, cpu, gang=None):
            pod = tobj.make_pod(name, requests={"cpu": cpu})
            pod.metadata.uid = f"uid-{name}"
            if gang:
                pod.spec.gang = tobj.GangSpec(name=gang, size=2)
            return (None, pod, "n1")

        kept, rejected = sched._rearbitrate_winners(
            [win("w1", "600m"), win("w2", "600m"), win("w3", "300m")])
        assert [w[1].metadata.name for w in kept] == ["w1", "w3"]
        assert [w[1].metadata.name for w in rejected] == ["w2"]
        kept, rejected = sched._rearbitrate_winners(
            [win("g1", "300m", "g"), win("g2", "900m", "g"),
             win("w4", "300m")])
        assert [w[1].metadata.name for w in kept] == ["w4"]
        assert [w[1].metadata.name for w in rejected] == ["g2", "g1"]
        sched._rearb_capacity = False
        kept, rejected = sched._rearbitrate_winners(
            [win("w5", "600m"), win("w6", "600m")])
        assert len(kept) == 2 and not rejected
    finally:
        sched.stop()
        factory.shutdown()


def _agg_sequence(objs, builder, build):
    """The JAX test's sequence of builds (``:256``) on ``objs``' nodes:
    (table after each step, the builder's dirty rows after it)."""
    nodes = [objs.make_node(f"n{i:02d}", capacity={"cpu": "8",
                                                   "memory": "16Gi",
                                                   "pods": 110})
             for i in range(10)]
    from_objs = (build_node_infos if objs is tobj else
                 __import__("minisched_tpu.framework.nodeinfo",
                            fromlist=["x"]).build_node_infos)
    infos = from_objs(nodes, [])
    by_name = {ni.name: ni for ni in infos}

    def bound(name, node, cpu="1", ports=()):
        p = objs.make_pod(name, requests={"cpu": cpu})
        p.metadata.uid = name
        p.spec.node_name = node
        if ports:
            p.spec.containers[0].ports = list(ports)
        return p

    out = []

    def step(**kw):
        out.append((frozen(build(builder, infos, **kw)),
                    builder.last_dirty_rows, builder.last_build_skipped))

    step(dirty=None)
    by_name["n02"].add_pod(bound("x1", "n02", "1"))
    by_name["n05"].add_pod(bound("x2", "n05", "2", ports=(8080,)))
    step(dirty={"n02", "n05"})
    by_name["n05"].remove_pod(bound("x2", "n05", "2", ports=(8080,)))
    step(dirty={"n05"})  # the port slot clears
    step(agg_delta={"n03": [500, 64, 0, 1, 500, 64, [9090]]}, dirty=set())
    step(dirty=set())  # the delta stayed out of the base
    by_name["n07"].add_pod(bound("x3", "n07", "1"))
    build(builder, infos)  # untracked: the base keeps its pending rows
    step(dirty={"n07"})
    step(dirty=set(), epoch=7)
    step(dirty=set(), epoch=7)  # nothing changed: reused
    infos2 = from_objs(nodes[:8], [])
    out.append((frozen(build(builder, infos2, dirty=None)),
                builder.last_dirty_rows, builder.last_build_skipped))
    return out, infos, infos2


def test_incremental_agg_base_matches_full_build_and_jax():
    """``:256``: every dirty-row build of the port's builder equals a
    fresh full build (port columns clear on re-encode; the assume delta
    never enters the base; an untracked build between tracked ones eats
    no pending increment; a membership change rebuilds), and equals the
    JAX builder over the same sequence, dirty-row counts included."""
    from minisched_tpu.api import objects as jobj
    from minisched_tpu.models.tables import CachedNodeTableBuilder as JBuilder

    def port_build(builder, infos, **kw):
        return builder.build(infos, **kw)

    def jax_build(builder, infos, **kw):
        return builder.build(infos, **kw)

    got, infos, infos2 = _agg_sequence(tobj, ttables.CachedNodeTableBuilder(
        "cpu"), port_build)
    want, _, _ = _agg_sequence(jobj, JBuilder(device_static=False), jax_build)
    assert len(got) == len(want) == 9
    for (g, g_rows, g_skip), (w, w_rows, w_skip) in zip(got, want):
        assert g[1] == w[1] and g_rows == w_rows and g_skip == w_skip
        assert_tables_equal(g[0], w[0])
    # nothing dirty, same delta, same nodes: the last tables come back
    assert [s for _, _, s in got] == [False] * 6 + [True, True, False]
    # a fresh builder's full build of the final state equals the last
    # incremental build of each roster
    fresh = ttables.CachedNodeTableBuilder("cpu")
    for (table, _), roster in ((got[7][0], infos), (got[8][0], infos2)):
        full, _ = fresh.build(roster, dirty=None)
        for name, col in ttables.table_columns(full).items():
            assert np.array_equal(col.numpy(), getattr(table, name).numpy()), name


def _dirty_sequence(objs, Cache):
    cache = Cache()
    drains = []

    def drain():
        _infos, _assigned, dirty, epoch = cache.snapshot_for_tables()
        drains.append(None if dirty is None else sorted(dirty))
        return epoch

    cache.add_node(objs.make_node("a"))
    cache.add_node(objs.make_node("b"))
    drain()
    p = objs.make_pod("p1", requests={"cpu": "1"})
    p.metadata.uid = "u1"
    p.spec.node_name = "a"
    cache.add_pod(p)
    cache.snapshot_with_assigned()  # a plain snapshot does not drain
    drain()
    e1 = drain()
    moved = objs.make_pod("p1", requests={"cpu": "2"})
    moved.metadata.uid = "u1"
    moved.spec.node_name = "b"
    cache.update_pod(p, moved)
    drain()
    cache.delete_pod(moved)
    e2 = drain()
    cache.add_node(objs.make_node("c"))  # membership: rebuild everything
    drain()
    cache.delete_node(objs.make_node("a"))
    drain()
    free, counted = cache.capacity_view({"b", "c", "gone"})
    return drains, e2 > e1, free, {k: sorted(v) for k, v in counted.items()}


def test_cache_dirty_tracking_matches_jax():
    """``:321``: the port's cache drains the same dirty sets as the JAX
    cache on the same events (None after a membership change), bumps its
    epoch on each, and gives the same capacity view."""
    from minisched_tpu.api import objects as jobj
    from minisched_tpu.engine.cache import SchedulerCache as JCache

    from minisched_tpu_torch.engine.cache import SchedulerCache as TCache

    got = _dirty_sequence(tobj, TCache)
    want = _dirty_sequence(jobj, JCache)
    assert got == want
    assert got[0] == [None, ["a"], [], ["a", "b"], ["b"], None, None]
    assert got[1]


def test_build_failure_goes_back_raw_and_binds(monkeypatch):
    """A build that raises hands its batch back raw: the serial path
    places it and nothing is counted as a loop error."""
    counters.reset()
    calls = []

    def broken(self, qpis):
        calls.append(len(qpis))
        raise RuntimeError("build exploded")

    monkeypatch.setattr(WavePipeline, "_build", broken)
    client = TClient()
    client.nodes().create(tobj.make_node("n0"))
    client.pods().create_many([tobj.make_pod(f"p{i}") for i in range(6)])
    svc = TService(client)
    try:
        sched = svc.start_scheduler(tconfig.default_full_roster_config(),
                                    device_mode=True, max_wave=4,
                                    device="cpu", pipeline=True)
        assert wait_for(lambda: bound_count(client) == 6)
        assert calls and counters.get("wave_pipeline.build_fallback") >= 1
        assert sched.loop_errors == 0
    finally:
        svc.close()


def test_worker_error_outside_a_build_is_counted(monkeypatch):
    """The worker survives an exception outside a build (here its pop),
    as the loop does, and counts it in ``loop_errors``; scheduling goes
    on."""
    client = TClient()
    client.nodes().create(tobj.make_node("n0"))
    svc = TService(client)
    try:
        sched = svc.start_scheduler(tconfig.default_full_roster_config(),
                                    device_mode=True, max_wave=4,
                                    device="cpu", pipeline=True)
        orig = sched.queue.pop_batch
        failed = []

        def flaky(*args, **kw):
            if not failed and threading.current_thread().name == "wave-build":
                failed.append(1)
                raise RuntimeError("pop exploded")
            return orig(*args, **kw)

        monkeypatch.setattr(sched.queue, "pop_batch", flaky)
        assert wait_for(lambda: sched.loop_errors == 1)
        assert "pop exploded" in str(sched.last_loop_error)
        client.pods().create(tobj.make_pod("after"))
        assert wait_for(lambda: client.pods().get("after").spec.node_name)
        assert sched.loop_errors == 1
    finally:
        svc.close()


def test_stop_parks_what_the_worker_popped():
    """A stop while the worker holds a built wave in the handoff parks
    its pods through ``error_func``: none is lost."""
    client = TClient()
    factory, sched = _engine(client, max_wave=4)
    try:
        client.nodes().create(tobj.make_node("n0"))
        assert wait_for(lambda: len(sched.cache.snapshot()) == 1)
        client.pods().create_many([tobj.make_pod(f"p{i}") for i in range(3)])
        assert wait_for(lambda: sched.queue.stats()["active"] == 3)
        pipe = sched._pipeline = WavePipeline(sched)
        pipe.start()  # no engine loop: the built wave waits in the handoff
        assert wait_for(lambda: pipe._handoff.full())
        # the loop's exit path, on this thread: stop, then park
        sched._stop.set()
        sched._loop()
        assert bound_count(client) == 0
        assert sched.queue.stats()["unschedulable"] == 3
    finally:
        sched.stop()
        factory.shutdown()


def test_pipelined_config5_with_spread_pods_audits():
    """Config 5 cut to 200 nodes and 2,000 pods with 100 spread pods
    through the pipelined live engine: every pod bound through park and
    requeue, the capacity and spread audits pass, the spread pods went
    through the scan lanes and the waves through the worker."""
    from minisched_tpu_torch import live

    run = live.run_config5_live(200, 2_000, max_wave=512, device="cpu",
                                timeout_s=120.0, n_crosspod=100)
    assert run.pipelined and run.loop_errors == 0 and run.assumed_left == 0
    assert live.audit_store(run.client, run.labelled)["bound"] == 2_000
    assert live.audit_spread(run.client) == 32
    lanes = run.scan_stats
    assert lanes["blocked"].placed + lanes["exact"].placed == 100
    assert run.counters["wave_pipeline.waves"] >= 4
    assert run.counters["wave_build.full"] >= 1
