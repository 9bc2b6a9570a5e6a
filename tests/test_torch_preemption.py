"""DefaultPreemption and the PostFilter point of the port, against JAX.

Every case of ``tests/test_preemption.py`` runs on the port's plugin and
engines and on the JAX package's, each with its own objects built alike
from the same code: the same victims (the pods left in the store), the
same nomination, the same status, and the JAX test's own expectation.
The live cases (the scalar engine, the device engine on the CPU, the
64-preemptor burst) run under the JAX tests' own timeouts.
"""

from __future__ import annotations

import random
import time
from types import SimpleNamespace

import pytest

from minisched_tpu.api import objects as jobj
from minisched_tpu.controlplane.client import Client as JClient
from minisched_tpu.framework import nodeinfo as jnodeinfo
from minisched_tpu.framework import plugin as jplugin
from minisched_tpu.framework import types as jtypes
from minisched_tpu.plugins import defaultpreemption as jdp
from minisched_tpu.plugins.noderesources import NodeResourcesFit as JFit
from minisched_tpu.plugins.registry import build_plugins as jbuild_plugins
from minisched_tpu.service import config as jconfig
from minisched_tpu.service.service import SchedulerService as JService

from minisched_tpu_torch.api import objects as tobj
from minisched_tpu_torch.controlplane.client import Client as TClient
from minisched_tpu_torch.framework import nodeinfo as tnodeinfo
from minisched_tpu_torch.framework import plugin as tplugin
from minisched_tpu_torch.framework import types as ttypes
from minisched_tpu_torch.plugins import defaultpreemption as tdp
from minisched_tpu_torch.plugins.noderesources import NodeResourcesFit as TFit
from minisched_tpu_torch.plugins.registry import build_plugins
from minisched_tpu_torch.service import config as tconfig
from minisched_tpu_torch.service.service import SchedulerService as TService

SIDES = {
    "jax": SimpleNamespace(objs=jobj, Client=JClient, types=jtypes,
                           infos=jnodeinfo.build_node_infos, dp=jdp, Fit=JFit,
                           Plugin=jplugin.Plugin, build=jbuild_plugins,
                           config=jconfig, Service=JService, kw={}),
    "port": SimpleNamespace(objs=tobj, Client=TClient, types=ttypes,
                            infos=tnodeinfo.build_node_infos, dp=tdp, Fit=TFit,
                            Plugin=tplugin.Plugin, build=build_plugins,
                            config=tconfig, Service=TService,
                            kw={"device": "cpu"}),
}


class _Handle:
    """The engine handle the plugin reads: its filter chain and client."""

    def __init__(self, client, filter_plugins):
        self.client = client
        self.filter_plugins = filter_plugins


def _assigned(m, name, node, cpu, priority=0):
    p = m.objs.make_pod(name, requests={"cpu": cpu}, priority=priority)
    p.metadata.uid = name
    p.spec.node_name = node
    return p


def _cluster(m, client, assigned, n_nodes=2, cpu="2"):
    nodes = [m.objs.make_node(f"n{i + 1}", capacity={"cpu": cpu,
                                                     "memory": "8Gi",
                                                     "pods": 10})
             for i in range(n_nodes)]
    for n in nodes:
        client.nodes().create(n)
    for p in assigned:
        client.pods().create(p)
    return m.infos(nodes, assigned)


def _post_filter(m, client, infos, pod, chain=None, diagnosis=None,
                 **dp_kw):
    dp = m.dp.DefaultPreemption(**dp_kw)
    dp.h = _Handle(client, chain if chain is not None else [m.Fit()])
    nominated, status = dp.post_filter(
        m.types.CycleState(), pod, infos,
        diagnosis if diagnosis is not None else m.types.Diagnosis())
    return {"nominated": nominated, "success": status.is_success(),
            "reasons": list(status.reasons),
            "survivors": sorted(p.metadata.name for p in client.pods().list()),
            "victims": sorted(v.metadata.name for v in dp.last_victims)}


# each case builds its cluster with one side's objects and returns what
# the plugin did; the test holds the port to JAX and both to the JAX
# test's expectation


def case_fewest_victims(m):
    client = m.Client()
    infos = _cluster(m, client, [_assigned(m, "small-a", "n1", "1"),
                                 _assigned(m, "small-b", "n1", "1"),
                                 _assigned(m, "big", "n2", "2")])
    pod = m.objs.make_pod("wants-2cpu", requests={"cpu": "2"}, priority=10)
    return _post_filter(m, client, infos, pod)


def case_lower_priority_only(m):
    client = m.Client()
    infos = _cluster(m, client, [_assigned(m, "peer-a", "n1", "2", 10),
                                 _assigned(m, "peer-b", "n2", "2", 10)])
    pod = m.objs.make_pod("same-prio", requests={"cpu": "2"}, priority=10)
    return _post_filter(m, client, infos, pod)


def case_lowest_priority_first(m):
    client = m.Client()
    infos = _cluster(m, client, [_assigned(m, "low", "n1", "1", 1),
                                 _assigned(m, "mid", "n1", "1", 5),
                                 _assigned(m, "blocker", "n2", "2", 9)])
    pod = m.objs.make_pod("wants-1cpu", requests={"cpu": "1"}, priority=10)
    return _post_filter(m, client, infos, pod)


def case_skips_unresolvable(m):
    client = m.Client()
    infos = _cluster(m, client, [_assigned(m, "small", "n1", "2", 0)])
    diagnosis = m.types.Diagnosis()
    diagnosis.node_to_status["n1"] = m.types.Status.unresolvable(
        "volume gone")
    pod = m.objs.make_pod("p", requests={"cpu": "1"}, priority=10)
    return _post_filter(m, client, infos, pod, diagnosis=diagnosis)


def case_reprieve(m):
    client = m.Client()
    infos = _cluster(m, client, [_assigned(m, "hi", "n1", "1", 8),
                                 _assigned(m, "mid", "n1", "2", 3),
                                 _assigned(m, "low", "n1", "1", 1)],
                     n_nodes=1, cpu="4")
    pod = m.objs.make_pod("wants-2cpu", requests={"cpu": "2"}, priority=10)
    return _post_filter(m, client, infos, pod)


def case_all_lower_insufficient(m):
    client = m.Client()
    infos = _cluster(m, client, [_assigned(m, "low", "n1", "1", 1),
                                 _assigned(m, "peer", "n1", "1", 10)],
                     n_nodes=1)
    pod = m.objs.make_pod("wants-2cpu", requests={"cpu": "2"}, priority=10)
    return _post_filter(m, client, infos, pod)


def case_pick_order(m):
    client = m.Client()
    infos = _cluster(m, client, [_assigned(m, "tiny-a", "n1", "1", 1),
                                 _assigned(m, "tiny-b", "n1", "1", 1),
                                 _assigned(m, "mid", "n2", "2", 5)])
    pod = m.objs.make_pod("wants-2cpu", requests={"cpu": "2"}, priority=10)
    return _post_filter(m, client, infos, pod)


def case_zero_victims(m):
    client = m.Client()
    infos = _cluster(m, client, [_assigned(m, "low", "n1", "1", 1)],
                     n_nodes=1, cpu="4")
    pod = m.objs.make_pod("fits", requests={"cpu": "1"}, priority=10)
    return _post_filter(m, client, infos, pod)


def case_candidate_cap(m):
    """The cap (absolute 2) stops the walk at n2: n3's single cheaper
    victim is never seen."""
    client = m.Client()
    infos = _cluster(m, client, [_assigned(m, "a", "n1", "2", 5),
                                 _assigned(m, "b", "n2", "2", 5),
                                 _assigned(m, "c", "n3", "2", 1)],
                     n_nodes=3)
    pod = m.objs.make_pod("p", requests={"cpu": "2"}, priority=10)
    return _post_filter(m, client, infos, pod,
                        min_candidate_nodes_percentage=10,
                        min_candidate_nodes_absolute=2)


CASES = {
    "fewest_victims": (case_fewest_victims,
                       {"nominated": "n2", "victims": ["big"]}),
    "lower_priority_only": (case_lower_priority_only,
                            {"nominated": None, "success": False,
                             "victims": []}),
    "lowest_priority_first": (case_lowest_priority_first,
                              {"nominated": "n1", "victims": ["low"]}),
    "skips_unresolvable": (case_skips_unresolvable,
                           {"nominated": None, "success": False,
                            "survivors": ["small"]}),
    "reprieve": (case_reprieve, {"nominated": "n1", "victims": ["mid"],
                                 "survivors": ["hi", "low"]}),
    "all_lower_insufficient": (case_all_lower_insufficient,
                               {"nominated": None, "success": False,
                                "survivors": ["low", "peer"]}),
    "pick_order": (case_pick_order, {"nominated": "n1",
                                     "survivors": ["mid"]}),
    "zero_victims": (case_zero_victims, {"nominated": "n1", "victims": [],
                                         "survivors": ["low"]}),
    "candidate_cap": (case_candidate_cap, {"nominated": "n1",
                                           "victims": ["a"]}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_post_filter_matches_jax(name):
    case, expect = CASES[name]
    got, want = case(SIDES["port"]), case(SIDES["jax"])
    assert got == want
    for key, value in expect.items():
        assert got[key] == value, key


def test_candidate_cap_math_matches_jax():
    for m in SIDES.values():
        dp = m.dp.DefaultPreemption(min_candidate_nodes_percentage=10,
                                    min_candidate_nodes_absolute=2)
        assert [dp._max_candidates(n) for n in (1000, 10, 1)] == [100, 2, 1]


def test_store_stamps_creation_timestamp():
    """The reprieve order and the pick's start-time rule read
    ``metadata.creation_timestamp``: the port's store stamps it on create
    and keeps it through updates."""
    client = TClient()
    client.nodes().create(tobj.make_node("n1"))
    created = client.pods().create(tobj.make_pod("p1"))
    assert created.metadata.creation_timestamp > 0
    created.metadata.labels["x"] = "y"
    updated = client.pods().update(created)
    assert (updated.metadata.creation_timestamp
            == created.metadata.creation_timestamp)


def _gate_trial(m, seed: int, hidden: bool):
    """One trial of the resource gate: with NodeResourcesFit (the gate on)
    or a plugin that filters as it does without being one (the gate off,
    every reprieve a full probe)."""
    rng = random.Random(seed)

    class _HiddenFit(m.Plugin):
        def __init__(self):
            self._inner = m.Fit()

        def name(self):
            return self._inner.name()

        def filter(self, state, pod, node_info):
            return self._inner.filter(state, pod, node_info)

    def sized(name, cpu, mem_gi, prio):
        p = m.objs.make_pod(name, requests={"cpu": cpu,
                                            "memory": f"{mem_gi}Gi"},
                            priority=prio)
        p.metadata.uid = name
        p.spec.node_name = "n1"
        return p

    n_pods = rng.randint(1, 8)
    node = m.objs.make_node("n1", capacity={
        "cpu": str(rng.randint(2, 8)), "memory": f"{rng.randint(2, 10)}Gi",
        "pods": rng.randint(1, 9)})
    assigned = [sized(f"p{i}", str(rng.randint(1, 3)), rng.randint(1, 3),
                      rng.randint(0, 6)) for i in range(n_pods)]
    pod = m.objs.make_pod("incoming", requests={
        "cpu": str(rng.randint(1, 4)),
        "memory": f"{rng.randint(1, 4)}Gi"}, priority=3)
    client = m.Client()
    client.nodes().create(node)
    for p in assigned:
        client.pods().create(p)
    return _post_filter(m, client, m.infos([node], assigned), pod,
                        chain=[_HiddenFit() if hidden else m.Fit()])


def test_resource_gate_matches_full_probes_and_jax():
    """The probe gate selects exactly the victims that full probes select,
    across 40 randomized clusters, on both packages."""
    victims = 0
    for trial in range(40):
        got = [_gate_trial(SIDES[side], 20260731 + trial, hidden)
               for side in ("port", "jax") for hidden in (False, True)]
        assert got[0] == got[1] == got[2] == got[3], (trial, got)
        victims += len(got[0]["victims"])
    assert victims > 0  # the gate decides somewhere


def test_default_preemption_args_flow_through_config():
    """DefaultPreemption's arguments pass customization and the build, as
    in JAX (the port has no simulator conversion yet)."""
    for m in SIDES.values():
        custom = m.config.SchedulerConfig(plugin_args={
            "DefaultPreemption": {"min_candidate_nodes_absolute": 7}})
        cfg = m.config.apply_plugin_customization(
            m.config.default_full_roster_config(), custom)
        assert [p.name for p in cfg.post_filter.enabled] == [
            "DefaultPreemption"]
        [dp] = m.build(cfg).post_filter
        assert dp.min_candidate_nodes_absolute == 7


# ---------------------------------------------------------------------------
# the live engines
# ---------------------------------------------------------------------------


def _wait(cond, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def _live_preemption(side, device_mode, timeout):
    """A node full of one priority-1 pod; a priority-100 pod arrives:
    (nomination seen, node bound, survivors, loop errors)."""
    m = SIDES[side]
    client = m.Client()
    svc = m.Service(client)
    cfg = m.config.default_full_roster_config(time_scale=0.01)
    cfg.queue_opts = {"initial_backoff_s": 0.05, "max_backoff_s": 0.2}
    kw = dict(device_mode=True, max_wave=16, **m.kw) if device_mode else {
        "device_mode": False}
    sched = svc.start_scheduler(cfg, **kw)
    try:
        client.nodes().create(m.objs.make_node(
            "n1", capacity={"cpu": "2", "memory": "8Gi", "pods": 10}))
        client.pods().create(m.objs.make_pod("low", requests={"cpu": "2"},
                                             priority=1))
        assert _wait(lambda: client.pods().get("low").spec.node_name == "n1",
                     timeout)
        client.pods().create(m.objs.make_pod("high", requests={"cpu": "2"},
                                             priority=100))
        nominated = _wait(
            lambda: client.pods().get("high").status.nominated_node_name
            == "n1" or client.pods().get("high").spec.node_name == "n1",
            timeout)
        assert _wait(lambda: client.pods().get("high").spec.node_name
                     == "n1", timeout)
        return (nominated, client.pods().get("high").spec.node_name,
                sorted(p.metadata.name for p in client.pods().list()),
                getattr(sched, "loop_errors", 0))
    finally:
        svc.shutdown_scheduler()


def test_live_preemption_scalar_engine():
    """The whole loop on the scalar engine: the victim evicted, its DELETE
    requeues the pod, which binds on the nominated node."""
    got = _live_preemption("port", device_mode=False, timeout=15.0)
    assert got == _live_preemption("jax", device_mode=False, timeout=15.0)
    assert got == (True, "n1", ["high"], 0)


def test_live_preemption_device_engine():
    """The same loop through the device engine's wave-loser pass."""
    got = _live_preemption("port", device_mode=True, timeout=60.0)
    assert got == _live_preemption("jax", device_mode=True, timeout=60.0)
    assert got == (True, "n1", ["high"], 0)


def _preemption_burst(side):
    """64 preemptors against 200 nodes full of evictable pods, on the
    device engine (JAX's scale case and its windows): (low pods placed,
    preemptors bound, low pods left, loop errors)."""
    m = SIDES[side]
    client = m.Client()
    for i in range(200):
        client.nodes().create(m.objs.make_node(
            f"node{i:03d}", capacity={"cpu": "4", "memory": "8Gi",
                                      "pods": 4}))
    for i in range(400):
        client.pods().create(m.objs.make_pod(
            f"low{i:04d}", requests={"cpu": "1900m"}, priority=1))
    svc = m.Service(client)
    placed = {}
    sched = svc.start_scheduler(
        m.config.default_full_roster_config(), device_mode=True,
        max_wave=128,
        on_decision=lambda p, n, s: placed.__setitem__(p.metadata.name, n),
        **m.kw)

    def count(prefix):
        return sum(1 for k, v in list(placed.items())
                   if k.startswith(prefix) and v)

    try:
        _wait(lambda: count("low") >= 400, 90)
        low_placed = count("low")
        for i in range(64):
            client.pods().create(m.objs.make_pod(
                f"high{i:03d}", requests={"cpu": "2100m"}, priority=100))
        _wait(lambda: count("high") >= 64, 60)
        left = [p for p in client.pods().list()
                if p.metadata.name.startswith("low")]
        return (low_placed, count("high"), len(left),
                getattr(sched, "loop_errors", 0))
    finally:
        svc.close()


def test_wave_preemption_at_scale_completes_quickly():
    """Each preemptor evicts exactly one 1,900m pod (a node holds two, and
    one eviction frees 2,100m): every preemptor bound, 64 evicted, on
    both packages."""
    got = _preemption_burst("port")
    assert got == _preemption_burst("jax")
    assert got == (400, 64, 336, 0)
