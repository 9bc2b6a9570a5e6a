"""``record_results`` against the JAX package, on the CPU: the retry
policy, the result store, the simulator wrappers, the configuration
conversion, the live recording of both engines, and the annotations of a
whole live run, pod for pod and key for key.

Every case of ``tests/test_observability.py:94-460`` that touches the
result store runs here on both packages (``pkg``).  The outputs are
strings, integers and bindings, so every comparison is exact.  Where two
engines run they take the serial path (``MINISCHED_PIPELINE=0``) over the
same cluster with the same pod uids.  Every wait has a deadline; every
service shuts down in a ``finally``.
"""

from __future__ import annotations

import json
from types import SimpleNamespace
from unittest import mock

import pytest

from minisched_tpu.api import objects as jobj
from minisched_tpu.controlplane import client as jclient
from minisched_tpu.controlplane import informer as jinformer
from minisched_tpu.framework import nodeinfo as jnodeinfo
from minisched_tpu.framework import types as jtypes
from minisched_tpu.models import tables as jtables
from minisched_tpu.observability import annotation as jannotation
from minisched_tpu.observability import resultstore as jresultstore
from minisched_tpu.ops import fused as jfused
from minisched_tpu.plugins import registry as jregistry
from minisched_tpu.plugins import simulator as jsimulator
from minisched_tpu.plugins.defaultpreemption import (
    preemption_might_help as j_might_help,
)
from minisched_tpu.service import config as jconfig
from minisched_tpu.service import service as jservice
from minisched_tpu.utils import retry as jretry

from minisched_tpu_torch.api import objects as tobj
from minisched_tpu_torch.controlplane import client as tclient
from minisched_tpu_torch.controlplane import informer as tinformer
from minisched_tpu_torch.framework import nodeinfo as tnodeinfo
from minisched_tpu_torch.framework import plugin as tplugin
from minisched_tpu_torch.framework import types as ttypes
from minisched_tpu_torch.models import tables as ttables
from minisched_tpu_torch.observability import annotation as tannotation
from minisched_tpu_torch.observability import resultstore as tresultstore
from minisched_tpu_torch.ops import fused as tfused
from minisched_tpu_torch.plugins import registry as tregistry
from minisched_tpu_torch.plugins import simulator as tsimulator
from minisched_tpu_torch.plugins.defaultpreemption import (
    preemption_might_help as t_might_help,
)
from minisched_tpu_torch.service import config as tconfig
from minisched_tpu_torch.service import service as tservice
from minisched_tpu_torch.utils import retry as tretry
from tests.test_torch_constraints import constraint_cluster
from tests.test_torch_engine import wait_for, with_uids

PKGS = {
    "jax": SimpleNamespace(
        objs=jobj, client=jclient, informer=jinformer, nodeinfo=jnodeinfo,
        types=jtypes, tables=jtables, annotation=jannotation,
        resultstore=jresultstore, fused=jfused, registry=jregistry,
        simulator=jsimulator, config=jconfig, service=jservice,
        retry=jretry, engine_kw={}),
    "torch": SimpleNamespace(
        objs=tobj, client=tclient, informer=tinformer, nodeinfo=tnodeinfo,
        types=ttypes, tables=ttables, annotation=tannotation,
        resultstore=tresultstore, fused=tfused, registry=tregistry,
        simulator=tsimulator, config=tconfig, service=tservice,
        retry=tretry, engine_kw={"device": "cpu"}),
}
KEYS = ("FILTER_RESULT", "SCORE_RESULT", "FINAL_SCORE_RESULT")


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


# -- fake plugins (plugins_test.go:981-1042) --------------------------------


def fakes(types):
    class FakeFilterPlugin:
        def __init__(self, reject: bool = False):
            self.reject = reject

        def name(self):
            return "FakeFilter"

        def filter(self, state, pod, node_info):
            if self.reject:
                return types.Status.unschedulable("fake says no")
            return types.Status.success()

    class FakeScorePlugin:
        def name(self):
            return "FakeScore"

        def score(self, state, pod, node_name):
            return len(node_name), types.Status.success()

        def score_extensions(self):
            return None

    class FakeNormalizingScorePlugin:
        def name(self):
            return "FakeNorm"

        def score(self, state, pod, node_name):
            return 10, types.Status.success()

        def score_extensions(self):
            class Ext:
                def normalize_score(self, state, pod, scores):
                    for ns in scores:
                        ns.score = ns.score * 2
                    return types.Status.success()

            return Ext()

    return FakeFilterPlugin, FakeScorePlugin, FakeNormalizingScorePlugin


# -- retry (util/retry.go) --------------------------------------------------


def test_retry_succeeds_after_failures(pkg):
    sleeps = []
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        return calls["n"] >= 3

    pkg.retry.retry_with_exponential_backoff(fn, sleep=sleeps.append)
    assert calls["n"] == 3
    assert sleeps == [0.1, 0.1 * 3]  # 100ms initial, factor 3


def test_retry_exhausts(pkg):
    with pytest.raises(pkg.retry.RetryTimeoutError):
        pkg.retry.retry_with_exponential_backoff(lambda: False,
                                                 sleep=lambda _: None)


def test_retry_jittered_schedule_equal_to_jax():
    import random

    want = list(jretry.backoff_delays(jitter=0.1, rng=random.Random(7)))
    got = list(tretry.backoff_delays(jitter=0.1, rng=random.Random(7)))
    assert got == want and len(got) == jretry.STEPS - 1


# -- store state transitions (store_test.go:17-406) -------------------------


def test_store_records_and_deletes(pkg):
    s = pkg.resultstore.Store()
    s.add_filter_result("default/p1", "n1", "PluginA", "reason")
    s.add_score_result("default/p1", "n1", "PluginA", 42)
    s.add_normalized_score_result("default/p1", "n1", "PluginA", 50,
                                  weight=2)
    f, sc, fin = s.get_data("default/p1")
    assert f == {"n1": {"PluginA": "reason"}}
    assert sc == {"n1": {"PluginA": 42}}
    assert fin == {"n1": {"PluginA": 100}}  # normalized × weight
    assert s.has_data("default/p1")
    s.delete_data("default/p1")
    assert not s.has_data("default/p1")


def test_store_flush_to_annotations_via_informer(pkg):
    """store.go:62-67,90-135: a pod Update event flushes results onto the
    pod's annotations and clears the entry."""
    client = pkg.client.Client()
    store = pkg.resultstore.Store(client)
    factory = pkg.informer.SharedInformerFactory(client.store)
    factory.informer_for("Pod").add_event_handlers(
        pkg.informer.ResourceEventHandlers(
            on_update=store.add_scheduling_result_to_pod))
    factory.start()
    try:
        pod = client.pods().create(pkg.objs.make_pod("p1"))
        store.add_filter_result(pod.metadata.key, "n1", "PluginA",
                                pkg.resultstore.PASSED_FILTER_MESSAGE)
        store.add_normalized_score_result(pod.metadata.key, "n1", "PluginA",
                                          77)
        client.pods().update(pod.clone())  # any update triggers the flush
        assert wait_for(lambda: pkg.annotation.FILTER_RESULT in client.pods(
        ).get("p1").metadata.annotations, 5)
        got = client.pods().get("p1").metadata.annotations
        assert json.loads(got[pkg.annotation.FILTER_RESULT]) == {
            "n1": {"PluginA": "passed"}}
        assert json.loads(got[pkg.annotation.FINAL_SCORE_RESULT]) == {
            "n1": {"PluginA": 77}}
        assert not store.has_data(pod.metadata.key)
    finally:
        factory.shutdown()


# -- simulator wrapper (plugins_test.go:389-772) ----------------------------


def test_wrapper_records_filter_results(pkg):
    FakeFilter, _, _ = fakes(pkg.types)
    store = mock.Mock(spec=pkg.resultstore.Store)
    [ni] = pkg.nodeinfo.build_node_infos([pkg.objs.make_node("n1")], [])
    pod = pkg.objs.make_pod("p")
    ok = pkg.simulator.make_simulator_plugin(FakeFilter(), store)
    assert ok.name() == "FakeFilterForSimulator"
    assert ok.filter(pkg.types.CycleState(), pod, ni).is_success()
    store.add_filter_result.assert_called_once_with(
        "default/p", "n1", "FakeFilter",
        pkg.resultstore.PASSED_FILTER_MESSAGE)

    store2 = mock.Mock(spec=pkg.resultstore.Store)
    bad = pkg.simulator.make_simulator_plugin(FakeFilter(reject=True), store2)
    assert not bad.filter(pkg.types.CycleState(), pod, ni).is_success()
    store2.add_filter_result.assert_called_once_with(
        "default/p", "n1", "FakeFilter", "fake says no")


def test_wrapper_records_scores_without_extensions(pkg):
    """A plugin without NormalizeScore records raw × weight as final."""
    _, FakeScore, _ = fakes(pkg.types)
    store = mock.Mock(spec=pkg.resultstore.Store)
    pod = pkg.objs.make_pod("p")
    w = pkg.simulator.make_simulator_plugin(FakeScore(), store, weight=3)
    score, st = w.score(pkg.types.CycleState(), pod, "node-a")
    assert score == len("node-a") and st.is_success()
    store.add_score_result.assert_called_once_with(
        "default/p", "node-a", "FakeScore", 6)
    store.add_normalized_score_result.assert_called_once_with(
        "default/p", "node-a", "FakeScore", 6, 3)


def test_wrapper_records_normalized_scores(pkg):
    _, _, FakeNorm = fakes(pkg.types)
    store = mock.Mock(spec=pkg.resultstore.Store)
    pod = pkg.objs.make_pod("p")
    w = pkg.simulator.make_simulator_plugin(FakeNorm(), store, weight=2)
    w.score(pkg.types.CycleState(), pod, "n1")
    store.add_normalized_score_result.assert_not_called()  # waits
    scores = [pkg.types.NodeScore("n1", 10), pkg.types.NodeScore("n2", 5)]
    st = w.score_extensions().normalize_score(pkg.types.CycleState(), pod,
                                              scores)
    assert st.is_success()
    assert [ns.score for ns in scores] == [20, 10]
    store.add_normalized_score_result.assert_any_call(
        "default/p", "n1", "FakeNorm", 20, 2)
    store.add_normalized_score_result.assert_any_call(
        "default/p", "n2", "FakeNorm", 10, 2)


def test_wrapper_capability_truthful(pkg):
    plugin = (tplugin if pkg is PKGS["torch"]
              else __import__("minisched_tpu.framework.plugin",
                              fromlist=["implements_filter"]))
    FakeFilter, FakeScore, _ = fakes(pkg.types)
    store = pkg.resultstore.Store()
    f = pkg.simulator.make_simulator_plugin(FakeFilter(), store)
    s = pkg.simulator.make_simulator_plugin(FakeScore(), store)
    assert plugin.implements_filter(f) and not plugin.implements_score(f)
    assert plugin.implements_score(s) and not plugin.implements_filter(s)


def test_wrapper_exposes_the_batch_half():
    """The port's wrapper reads the batch half through, so the device
    engine runs wrapped chains: a wrapped NodeResourcesFit masks as the
    plain one and passes the registry's batch checks."""
    from minisched_tpu_torch.plugins.noderesources import NodeResourcesFit

    inner = NodeResourcesFit()
    w = tsimulator.make_simulator_plugin(inner, tresultstore.Store())
    assert tplugin.implements_batch(w)
    assert w.batch_filter == inner.batch_filter
    assert w.needs_extra == inner.needs_extra
    tregistry.inject(w, "store_client", "client")
    assert inner.store_client == "client"


# -- config conversion (ConvertForSimulator, plugins.go:146-202) ------------


def test_convert_for_simulator(pkg):
    c = pkg.config
    ps = c.PluginSet(enabled=[c.PluginEnabled("NodeResourcesFit"),
                              c.PluginEnabled("TaintToleration", 3)])
    out = pkg.simulator.convert_for_simulator(ps)
    assert [e.name for e in out.enabled] == [
        "NodeResourcesFitForSimulator", "TaintTolerationForSimulator"]
    assert out.enabled[1].weight == 3
    assert out.disabled == ["*"]


def test_registered_simulator_plugins_build(pkg):
    store = pkg.resultstore.Store()
    cfg = pkg.config.default_full_roster_config()
    pkg.simulator.register_simulator_plugins(
        store, {e.name: e.weight for e in cfg.score.enabled})
    converted = pkg.simulator.convert_configuration_for_simulator(cfg)
    chains = pkg.registry.build_plugins(converted)
    assert all(p.name().endswith("ForSimulator") for p in chains.filter)
    assert all(p.name().endswith("ForSimulator") for p in chains.score)
    assert {p.name() for p in chains.filter} == {
        pkg.simulator.plugin_name(e.name) for e in cfg.filter.enabled}


def test_registered_names_and_reasons_equal_jax():
    """Every built-in gets its wrapper under the JAX name, and the wave
    path's rejection strings are JAX's letter for letter."""
    jsimulator.register_simulator_plugins(jresultstore.Store())
    tsimulator.register_simulator_plugins(tresultstore.Store())
    tnames = set(tregistry.registered_names())
    assert tnames <= set(jregistry.registered_names())
    assert {n for n in tnames if not n.endswith("ForSimulator")} == {
        n.removesuffix("ForSimulator") for n in tnames
        if n.endswith("ForSimulator")}
    assert tregistry.canonical_filter_reasons() == (
        jregistry.canonical_filter_reasons())


# -- preemption gating under the simulator names ----------------------------


@pytest.mark.parametrize("failed", [
    set(), {"NodeUnschedulable"}, {"NodeUnschedulableForSimulator"},
    {"TaintTolerationForSimulator", "VolumeZoneForSimulator"},
    {"NodeResourcesFitForSimulator"},
    {"NodeAffinityForSimulator", "NodeResourcesFitForSimulator"}])
def test_preemption_might_help_strips_the_suffix(failed):
    diag = SimpleNamespace(unschedulable_plugins=failed)
    assert t_might_help(diag) == j_might_help(diag)
    assert t_might_help(SimpleNamespace(unschedulable_plugins={
        n.removesuffix("ForSimulator") for n in failed})) == t_might_help(diag)


# -- end to end: live recording ---------------------------------------------


def _wait_annotated(client, name, annotation, timeout=10):
    def done():
        got = client.pods().get(name)
        return (got.spec.node_name
                and annotation.FILTER_RESULT in got.metadata.annotations)

    assert wait_for(done, timeout)
    return client.pods().get(name)


def test_live_scheduler_records_results_onto_annotations(pkg):
    client = pkg.client.Client()
    svc = pkg.service.SchedulerService(client)
    svc.start_scheduler(pkg.config.default_scheduler_config(time_scale=0.01),
                        record_results=True, device_mode=False)
    try:
        client.nodes().create(pkg.objs.make_node("node1"))
        client.pods().create(pkg.objs.make_pod("pod1"))
        got = _wait_annotated(client, "pod1", pkg.annotation)
    finally:
        svc.shutdown_scheduler()
    assert got.spec.node_name == "node1"
    ann = got.metadata.annotations
    filt = json.loads(ann[pkg.annotation.FILTER_RESULT])
    assert filt["node1"]["NodeUnschedulable"] == (
        pkg.resultstore.PASSED_FILTER_MESSAGE)
    final = json.loads(ann[pkg.annotation.FINAL_SCORE_RESULT])
    assert final["node1"]["NodeNumber"] == 10  # pod1's suffix is node1's


def test_device_mode_records_wave_results_onto_annotations(pkg):
    """record_results with the device engine: each wave is recorded by one
    diagnostics evaluation and flushed onto the pods when they bind."""
    client = pkg.client.Client()
    for i in range(4):
        client.nodes().create(pkg.objs.make_node(
            f"node{i}", capacity={"cpu": "2", "memory": "4Gi", "pods": 110}))
    for i in range(3):
        client.pods().create(pkg.objs.make_pod(f"pod{i}",
                                               requests={"cpu": "250m"}))
    svc = pkg.service.SchedulerService(client)
    sched = svc.start_scheduler(pkg.config.default_full_roster_config(),
                                record_results=True, device_mode=True,
                                max_wave=8, **pkg.engine_kw)
    try:
        got = [_wait_annotated(client, f"pod{i}", pkg.annotation, 60)
               for i in range(3)]
        if pkg is PKGS["torch"]:
            assert sched.record_errors == 0 and sched.loop_errors == 0
            assert not sched._pipeline_active()
    finally:
        svc.shutdown_scheduler()
    rec = json.loads(got[0].metadata.annotations[pkg.annotation.FILTER_RESULT])
    assert rec["node0"]["NodeUnschedulable"] == "passed"
    assert "NodeResourcesFit" in rec["node0"]  # unwrapped names
    score = json.loads(got[0].metadata.annotations[
        pkg.annotation.SCORE_RESULT])
    assert "TaintToleration" in score["node0"]


def test_device_mode_nodenumber_roster_fails_as_jax(monkeypatch):
    """The reference's own fault, kept: ``record_results`` converts the
    filter and score sets but not pre-score, so in device mode the wrapped
    NodeNumber scorer looks its pre-score aux up under its
    ``ForSimulator`` name and every wave raises ``KeyError:
    'pod_suffix'`` (JAX prints it from ``_record_wave`` and parks the wave
    in the evaluation).  The port fails the same way and counts both."""
    monkeypatch.setenv("MINISCHED_PIPELINE", "0")
    client = tclient.Client()
    svc = tservice.SchedulerService(client)
    sched = svc.start_scheduler(tconfig.default_scheduler_config(
        time_scale=0.01), record_results=True, device="cpu")
    try:
        client.nodes().create(tobj.make_node("node1"))
        client.pods().create(tobj.make_pod("pod1"))
        assert wait_for(lambda: sched.loop_errors >= 1
                        and sched.record_errors >= 1, 10)
        assert isinstance(sched.last_record_error, KeyError)
        assert isinstance(sched.last_loop_error, KeyError)
        assert client.pods().get("pod1").spec.node_name == ""
    finally:
        svc.shutdown_scheduler()


def test_restart_keeps_result_recording(pkg):
    """restart_scheduler re-wires the flush handler and does not convert
    twice."""
    client = pkg.client.Client()
    svc = pkg.service.SchedulerService(client)
    svc.start_scheduler(pkg.config.default_scheduler_config(time_scale=0.01),
                        record_results=True, device_mode=False)
    try:
        svc.restart_scheduler()
        cfg = svc.get_scheduler_config()
        assert all("ForSimulator" not in e.name for e in cfg.filter.enabled)
        client.nodes().create(pkg.objs.make_node("node1"))
        client.pods().create(pkg.objs.make_pod("pod1"))
        got = _wait_annotated(client, "pod1", pkg.annotation)
    finally:
        svc.shutdown_scheduler()
    assert got.spec.node_name == "node1"
    assert not svc.result_store.has_data("default/pod1")


def test_flush_does_not_clobber_concurrent_bind(pkg):
    """The annotation flush is an atomic mutate: a bind landing between
    read and write survives."""
    client = pkg.client.Client()
    store = pkg.resultstore.Store(client)
    pod = client.pods().create(pkg.objs.make_pod("p1"))
    store.add_filter_result(pod.metadata.key, "n1", "PluginA", "passed")
    real_mutate = client.store.mutate
    bound = {"done": False}

    def racing_mutate(kind, ns, name, fn):
        if not bound["done"]:  # the binding lands first
            bound["done"] = True
            client.pods().bind(pkg.objs.Binding("p1", "default", "n1"))
        return real_mutate(kind, ns, name, fn)

    client.store.mutate = racing_mutate
    try:
        store.add_scheduling_result_to_pod(pod, pod)
    finally:
        client.store.mutate = real_mutate
    got = client.pods().get("p1")
    assert got.spec.node_name == "n1"  # the bind survived
    assert pkg.annotation.FILTER_RESULT in got.metadata.annotations


# -- batch bridge: diagnostics land in the same store -----------------------


def test_record_batch_result_from_diagnostics(pkg):
    from importlib import import_module

    root = "minisched_tpu" if pkg is PKGS["jax"] else "minisched_tpu_torch"
    NodeNumber = import_module(f"{root}.plugins.nodenumber").NodeNumber
    NodeUnschedulable = import_module(
        f"{root}.plugins.nodeunschedulable").NodeUnschedulable
    nodes = [pkg.objs.make_node("n0", unschedulable=True),
             pkg.objs.make_node("n1")]
    kw = {} if pkg is PKGS["jax"] else {"device": "cpu"}
    node_table, node_names = pkg.tables.build_node_table(nodes, **kw)
    pod_table, _ = pkg.tables.build_pod_table([pkg.objs.make_pod("p1")], **kw)
    nn = NodeNumber()
    ev = pkg.fused.FusedEvaluator([NodeUnschedulable()], [nn], [nn],
                                  with_diagnostics=True)
    store = pkg.resultstore.Store()
    store.record_batch_result(
        ev(pod_table, node_table), ["default/p1"], node_names,
        ["NodeUnschedulable"], ["NodeNumber"],
        reasons={"NodeUnschedulable": "node(s) were unschedulable"})
    filt, score, final = store.get_data("default/p1")
    assert filt["n0"]["NodeUnschedulable"] == "node(s) were unschedulable"
    assert filt["n1"]["NodeUnschedulable"] == (
        pkg.resultstore.PASSED_FILTER_MESSAGE)
    assert score["n1"]["NodeNumber"] == 10  # raw, before normalize
    assert final["n1"]["NodeNumber"] == 10


@pytest.mark.parametrize("seed", [3, 11])
def test_record_batch_result_equal_to_jax_full_roster(seed):
    """The port's ``record_batch_result`` on its diagnostics evaluation
    equals JAX's on the same cluster, with the full roster, the canonical
    reasons and padded tables (more rows and columns than pods and
    nodes): every pod's three maps, node for node and plugin for
    plugin."""
    from minisched_tpu.models.constraints import (
        build_constraint_tables as j_constraints,
    )

    from minisched_tpu_torch.models.constraints import (
        build_constraint_tables as t_constraints,
    )

    got = {}
    for side, pk, build_constraints, kw in (
            ("jax", PKGS["jax"], j_constraints, {}),
            ("torch", PKGS["torch"], t_constraints, {"device": "cpu"})):
        nodes, assigned, pods, pvcs, pvs = constraint_cluster(
            pk.objs, seed, n_nodes=12, n_assigned=10, n_pods=9)
        cfg = pk.config.default_full_roster_config()
        chains = pk.registry.build_plugins(cfg)
        by_node = {}
        for p in assigned:
            by_node.setdefault(p.spec.node_name, []).append(p)
        node_table, names = pk.tables.build_node_table(
            nodes, by_node, capacity=16, **kw)
        pod_table, _ = pk.tables.build_pod_table(pods, capacity=16, **kw)
        extra = build_constraints(pods, nodes, assigned, pvcs=pvcs, pvs=pvs,
                                  pod_capacity=16, node_capacity=16, **kw)
        ev = pk.fused.FusedEvaluator(chains.filter, chains.pre_score,
                                     chains.score,
                                     weights=cfg.score_weights(),
                                     with_diagnostics=True)
        store = pk.resultstore.Store()
        keys = [p.metadata.key for p in pods]
        store.record_batch_result(
            ev(pod_table, node_table, extra), keys, names,
            [p.name() for p in chains.filter],
            [p.name() for p in chains.score],
            reasons=pk.registry.canonical_filter_reasons())
        got[side] = {k: store.get_data(k) for k in keys}
    assert got["torch"] == got["jax"]
    some = next(iter(got["jax"].values()))
    assert len(some[0]) == 12 and len(next(iter(some[0].values()))) == 15


# -- the annotations of a whole live run ------------------------------------


def _annotations(client, annotation):
    out = {}
    for p in client.pods().list():
        ann = p.metadata.annotations
        out[p.metadata.name] = (p.spec.node_name, tuple(
            json.loads(ann[getattr(annotation, k)])
            if getattr(annotation, k) in ann else None for k in KEYS))
    return out


def _recorded_run(side, monkeypatch, device_mode, spy=None):
    """The mixed cluster through one engine with ``record_results``:
    (pod name → (node, parsed annotations), the engine).  The device
    engine gets every pending pod up front (FIFO waves).  The scalar
    engine's cycle reads the informer cache, which a previous bind may not
    have reached yet, so there the pods arrive one at a time, each after
    the one before is bound and flushed, or parked and deleted: every
    cycle then sees one store state in both packages."""
    pk = PKGS[side]
    monkeypatch.setenv("MINISCHED_PIPELINE", "0")
    nodes, assigned, pods, pvcs, pvs = constraint_cluster(
        pk.objs, 5, n_nodes=10, n_assigned=12, n_pods=30)
    client = pk.client.Client()
    for pvc in pvcs:
        client.store.create("PersistentVolumeClaim", pvc)
    for pv in pvs:
        client.store.create("PersistentVolume", pv)
    client.nodes().create_many(nodes)
    for i, p in enumerate(assigned):
        p.metadata.uid = f"assigned-{i:08d}"
    client.pods().create_many(assigned)
    pods = with_uids(pods)
    if device_mode:
        client.pods().create_many(pods)
    svc = pk.service.SchedulerService(client)
    kw = pk.engine_kw if device_mode else {}
    sched = svc.start_scheduler(
        pk.config.default_full_roster_config(time_scale=0.01),
        record_results=True, device_mode=device_mode, max_wave=16, **kw)
    if spy is not None:
        spy(sched)

    def settled(names):
        st = sched.queue.stats()
        done = [p for p in client.pods().list()
                if p.metadata.name in names and p.spec.node_name]
        flushed = all(not svc.result_store.has_data(p.metadata.key)
                      and pk.annotation.FILTER_RESULT in p.metadata.annotations
                      for p in done)
        return (st["active"] == 0 and st["backoff"] == 0 and flushed
                and len(done) + st["unschedulable"] == len(names))

    try:
        if device_mode:
            assert wait_for(lambda: settled({p.metadata.name for p in pods}),
                            60)
        for p in pods if not device_mode else ():
            client.pods().create(p)
            assert wait_for(lambda: settled({p.metadata.name}), 10)
            if not client.pods().get(p.metadata.name).spec.node_name:
                client.pods().delete(p.metadata.name)
                assert wait_for(
                    lambda: sched.queue.stats()["unschedulable"] == 0, 10)
        if device_mode and side == "torch":
            assert sched.loop_errors == 0 and sched.record_errors == 0
        return _annotations(client, pk.annotation), sched
    finally:
        svc.close()


def test_live_annotations_equal_jax_device_engine(monkeypatch):
    """A cluster with every full-roster feature and cross-pod pods,
    through the device engine with ``record_results``: the waves record
    the plain pods, the exact scan the cross-pod ones (one flush of at
    most 32), and every pod's bindings and parsed annotations equal the
    JAX engine's."""
    lanes = {}

    def spy(sched):
        orig = sched._record_wave

        def counted(pods_, *args):
            lanes.setdefault("records", []).append(len(pods_))
            return orig(pods_, *args)

        sched._record_wave = counted

    got, sched = _recorded_run("torch", monkeypatch, True, spy)
    want, _ = _recorded_run("jax", monkeypatch, True)
    assert got == want
    assert sched.scan_stats["exact"].placed > 0
    assert sched.scan_stats["blocked"].calls == 0
    placed = [k for k, (node, ann) in got.items()
              if node and not k.startswith("asg")]
    # every pod the waves or the exact scan placed carries its record
    assert placed and all(got[k][1][0] is not None for k in placed)
    assert len(lanes["records"]) >= 2


def test_live_annotations_equal_jax_scalar_engine(monkeypatch):
    """The same cluster through both scalar engines: equal bindings and
    equal annotations, recorded by the wrappers cycle by cycle."""
    got, _ = _recorded_run("torch", monkeypatch, False)
    want, _ = _recorded_run("jax", monkeypatch, False)
    assert got == want
    assert any(ann[0] is not None for _node, ann in got.values())
