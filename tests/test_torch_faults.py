"""The port's fault fabric (``faults/__init__.py``) and network-fault
layer (``faults/net.py``) on the CPU.

The port's copies of JAX's fabric, retry-jitter and store-level tests of
``tests/test_faults.py`` and of
``tests/test_partition_chaos.py::test_net_fabric_rules_channels_and_schedule``,
under JAX's names; then, for the same seeds and the same calls, the
port's ``FaultFabric`` and ``NetFabric`` decide every call as JAX's do
(call for call, fire counts and stats included), and the WAL
double-bind audit now in ``faults`` answers as JAX's.  The tests of
points that wait for the rest of ROADMAP item 8 (``watch.drop``,
``http.500``/``http.reset``, ``remote.request``) are named there, not
copied.
"""

from __future__ import annotations

import random
import time

import pytest

from minisched_tpu import faults as jfaults
from minisched_tpu.faults import net as jnet

from minisched_tpu_torch import faults as tfaults
from minisched_tpu_torch.api.objects import Binding, make_node, make_pod
from minisched_tpu_torch.controlplane.client import Client
from minisched_tpu_torch.controlplane.durable import DurableObjectStore
from minisched_tpu_torch.controlplane.store import ObjectStore
from minisched_tpu_torch.faults import FaultFabric, InjectedFault
from minisched_tpu_torch.faults import net as tnet
from minisched_tpu_torch.faults.net import NetFabric, NetPartitioned


# -- fabric ----------------------------------------------------------------


def _fire_pattern(seed: int, calls):
    fab = FaultFabric(seed).on("p", rate=0.3)
    return [fab.should_fire("p", key) for key in calls]


def test_fabric_schedule_is_deterministic_for_a_seed():
    calls = [f"k{i % 7}" for i in range(500)]
    a = _fire_pattern(42, calls)
    b = _fire_pattern(42, calls)
    assert a == b, "same seed + same call sequence must fire identically"
    assert any(a), "rate 0.3 over 500 calls must fire"
    assert not all(a)
    c = _fire_pattern(43, calls)
    assert a != c, "a different seed must produce a different schedule"


def test_fabric_decisions_are_per_key_ordinal_not_global():
    """Thread-interleaving independence: the decision for call n at
    (point, key) must not depend on calls at OTHER keys in between."""
    fab1 = FaultFabric(7).on("p", rate=0.5)
    seq1 = [fab1.should_fire("p", "a") for _ in range(50)]
    fab2 = FaultFabric(7).on("p", rate=0.5)
    seq2 = []
    for _ in range(50):
        fab2.should_fire("p", "b")  # interleaved traffic at another key
        seq2.append(fab2.should_fire("p", "a"))
    assert seq1 == seq2


def test_fabric_after_max_fires_and_keys():
    fab = FaultFabric(1).on("p", rate=1.0, after=2, max_fires=3)
    fires = [fab.should_fire("p", "k") for _ in range(10)]
    assert fires == [False, False, True, True, True] + [False] * 5
    assert fab.fires("p") == 3

    fab = FaultFabric(1).on("w", rate=1.0, keys={"Pod"})
    assert not fab.should_fire("w", "Node")
    assert fab.should_fire("w", "Pod")
    assert fab.stats()["calls"]["w"] == 2

    # unarmed points never fire and raise nothing
    fab.check("unarmed", "x")


def test_fabric_check_raises_injected_fault():
    fab = FaultFabric(1).on("p", rate=1.0)
    with pytest.raises(InjectedFault):
        fab.check("p", "k")


# -- retry jitter ----------------------------------------------------------


def test_backoff_delays_jitter_bounds_and_reproducibility():
    import random

    from minisched_tpu_torch.utils.retry import (
        backoff_delays,
        retry_with_exponential_backoff,
    )

    base = list(backoff_delays(0.1, 3.0, 6, jitter=0.0))
    assert base == pytest.approx([0.1, 0.3, 0.9, 2.7, 8.1])  # legacy schedule
    j1 = list(backoff_delays(0.1, 3.0, 6, jitter=0.5, rng=random.Random(9)))
    j2 = list(backoff_delays(0.1, 3.0, 6, jitter=0.5, rng=random.Random(9)))
    assert j1 == j2, "seeded rng makes the jittered schedule reproducible"
    for b, j in zip(base, j1):
        assert b <= j <= b * 1.5, "wait.Jitter semantics: [d, d*(1+jitter)]"

    # the default call shape is byte-exact with the pre-jitter behavior
    slept = []
    attempts = [0]

    def fn():
        attempts[0] += 1
        return attempts[0] >= 3

    retry_with_exponential_backoff(fn, sleep=slept.append)
    assert slept == [0.1, 0.30000000000000004]


# -- store-level injection -------------------------------------------------


def test_store_get_and_list_consult_the_injector():
    store = ObjectStore()
    store.create("Node", make_node("n1"))
    fab = FaultFabric(3).on("store.get", rate=1.0, max_fires=1).on(
        "store.list", rate=1.0, max_fires=1
    )
    store.fault_injector = fab.as_store_injector()
    with pytest.raises(InjectedFault):
        store.get("Node", "", "n1")
    assert store.get("Node", "", "n1").metadata.name == "n1"  # recovered
    with pytest.raises(InjectedFault):
        store.list("Node")
    assert len(store.list("Node")) == 1


def test_wal_append_fault_fails_before_the_inmemory_commit(tmp_path):
    wal = str(tmp_path / "t.wal")
    store = DurableObjectStore(wal)
    fab = FaultFabric(5).on("wal.append", rate=1.0, max_fires=1)
    store.faults = fab
    with pytest.raises(InjectedFault):
        store.create("Node", make_node("n1"))
    # the refused mutation touched NOTHING: no object, no watch event
    assert store.list("Node") == []
    store.create("Node", make_node("n1"))  # next attempt lands
    store.close()
    store2 = DurableObjectStore(wal)
    assert [n.metadata.name for n in store2.list("Node")] == ["n1"]
    store2.close()


def test_net_fabric_rules_channels_and_schedule():
    """The in-process NetFabric contract: directional imposed rules per
    channel, wildcard dst, heal, the delay mode's imposed latency, the
    blackhole mode's capped hang, and the blake2s-scheduled ``net.drop``
    point replaying identically from a seed."""
    net = NetFabric().configure(identity="a")
    net.check("b")  # no rules: every link up
    net.cut("a", "b", channel="arbiter")
    with pytest.raises(NetPartitioned):
        net.check("b", channel="arbiter")
    net.check("b", channel="data")  # other channel untouched
    with pytest.raises(ValueError):
        net.cut("a", "b", mode="sever")
    net.cut("*", "c")  # any local actor -> c, every channel
    with pytest.raises(NetPartitioned):
        net.check("c", src="z")
    assert net.heal("a", "b") is True
    net.check("b", channel="arbiter")
    net.heal_all()

    net.cut("a", "b", mode="delay", delay_s=0.05)
    t0 = time.monotonic()
    net.check("b")  # delayed, then allowed through
    assert time.monotonic() - t0 >= 0.05
    net.heal_all()

    net.cut("a", "b", mode="blackhole")
    t0 = time.monotonic()
    with pytest.raises(NetPartitioned):
        net.check("b", timeout_s=0.1)
    assert 0.1 <= time.monotonic() - t0 < 1.0, "hang must respect timeout"
    net.heal_all()

    def verdicts(seed: int) -> list:
        f = NetFabric().configure(identity="a").flake(rate=0.5, seed=seed)
        out = []
        for _ in range(24):
            try:
                f.check("b")
                out.append(True)
            except NetPartitioned:
                out.append(False)
        return out

    assert verdicts(77) == verdicts(77), "schedule must replay from seed"
    assert False in verdicts(77) and True in verdicts(77)


# -- the port against the JAX package -----------------------------------------

FABRICS = {"jax": jfaults, "port": tfaults}
NETS = {"jax": jnet, "port": tnet}


def _fabric_trace(side, seed):
    """A seeded sequence of calls over several armed points (rates,
    ``after``, ``max_fires``, ``keys``) and one unarmed point: every
    decision, then the fire counts and stats."""
    mod = FABRICS[side]
    fab = (mod.FaultFabric(seed)
           .on("a", rate=0.3)
           .on("b", rate=0.7, after=3, max_fires=9)
           .on("c", rate=1.0, keys={"k1", "k3"}))
    rng = random.Random(seed)
    out = []
    for _ in range(600):
        point = rng.choice("abcz")
        key = f"k{rng.randrange(5)}"
        try:
            fab.check(point, key)
            out.append(False)
        except mod.InjectedFault:
            out.append(True)
    inj = fab.as_store_injector()
    for i in range(50):
        try:
            inj("get", "Pod", f"default/p{i % 4}")
            out.append(False)
        except mod.InjectedFault:
            out.append(True)
    return out, {p: fab.fires(p) for p in "abcz"}, fab.stats()


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_fabric_decisions_equal_jax_call_for_call(seed):
    want = _fabric_trace("jax", seed)
    got = _fabric_trace("port", seed)
    assert got == want
    assert any(want[0]) and not all(want[0])


def _net_trace(side, seed):
    """Scheduled ``net.drop`` verdicts over several links, then imposed
    rules by channel and wildcard, then the describe() document."""
    mod = NETS[side]
    net = mod.NetFabric().configure(identity="r0").flake(rate=0.4,
                                                         seed=seed)
    rng = random.Random(seed)
    out = []
    for _ in range(300):
        dst = f"r{rng.randrange(1, 4)}"
        src = rng.choice(["", "r0", "r9"])
        try:
            net.check(dst, channel=rng.choice(["data", "arbiter"]), src=src)
            out.append(True)
        except mod.NetPartitioned:
            out.append(False)
    net.cut("r0", "r1", channel="arbiter")
    net.cut("*", "r2")
    for dst, channel in (("r1", "arbiter"), ("r1", "data"), ("r2", "data"),
                         ("r2", "arbiter")):
        try:
            net.check(dst, channel=channel)
            out.append((dst, channel, "up"))
        except mod.NetPartitioned as e:
            out.append((dst, channel, str(e)))
    return out, net.describe()


@pytest.mark.parametrize("seed", [3, 77])
def test_net_fabric_decisions_equal_jax_call_for_call(seed):
    want = _net_trace("jax", seed)
    got = _net_trace("port", seed)
    assert got == want
    assert False in want[0] and True in want[0]


def test_wal_double_binds_equal_jax(tmp_path):
    """A WAL with one pod bound to two nodes (written around the bind
    precondition): the port's audit names the same violation as JAX's,
    and a clean WAL none."""
    wal = str(tmp_path / "d.wal")
    store = DurableObjectStore(wal)
    client = Client(store=store)
    client.nodes().create_many([make_node("n1"), make_node("n2")])
    client.pods().create_many([make_pod("p0"), make_pod("p1")])
    client.pods().bind_many([Binding("p0", "default", "n1")])
    assert tfaults.wal_double_binds(wal) == jfaults.wal_double_binds(wal) \
        == []
    moved = store.get("Pod", "default", "p0")
    moved.spec.node_name = "n2"
    store.update("Pod", moved)
    store.close()
    got = tfaults.wal_double_binds(wal)
    assert got == jfaults.wal_double_binds(wal)
    assert got == [(moved.metadata.uid, "n1", "n2")]
