"""The port's scheduling queue and event maps against the JAX package's.

``minisched_tpu_torch/queue/queue.py`` is a copy of the JAX
``SchedulingQueue`` without the namespace quota.  A scripted sequence of
adds, ``pop_batch`` waves, parks, cluster events, move requests, updates,
deletes and flushes — driven by one seed, with a fake backoff clock —
must give the same pop order and the same ``stats()`` after every step on
both queues, gang members included (adjacent and whole within a wave).

The engine's ``ClusterEventMap`` comes from its plugins' registrations:
for every roster it is compared key for key with the JAX engine's.  Both
comparisons are exact.
"""

from __future__ import annotations

import numpy as np
import pytest

from minisched_tpu.api import objects as jobj
from minisched_tpu.framework import events as jevents
from minisched_tpu.framework.plugin import implements_enqueue as j_enqueue
from minisched_tpu.framework.types import QueuedPodInfo as JQPI, PodInfo as JPodInfo
from minisched_tpu.plugins import registry as jregistry
from minisched_tpu.queue.queue import SchedulingQueue as JQueue
from minisched_tpu.service import config as jconfig

from minisched_tpu_torch.api import objects as tobj
from minisched_tpu_torch.framework import events as tevents
from minisched_tpu_torch.framework.plugin import implements_enqueue as t_enqueue
from minisched_tpu_torch.framework.types import QueuedPodInfo as TQPI, PodInfo as TPodInfo
from minisched_tpu_torch.plugins import registry as tregistry
from minisched_tpu_torch.queue.queue import SchedulingQueue as TQueue
from minisched_tpu_torch.service import config as tconfig

SIDES = {
    "jax": (jobj, jevents, JQueue, JQPI, JPodInfo),
    "port": (tobj, tevents, TQueue, TQPI, TPodInfo),
}

#: plugin → events, as a roster registers them (names only matter to the
#: queue's gating)
_REGISTRATIONS = (
    ("NodeResourcesFit", (("POD", "DELETE"), ("NODE", "ADD"),
                          ("NODE", "UPDATE_NODE_ALLOCATABLE"))),
    ("NodeAffinity", (("NODE", "ADD"), ("NODE", "UPDATE_NODE_LABEL"))),
    ("Coscheduling", (("POD", "UPDATE"),)),
)
_EVENTS = (("NODE", "ADD"), ("NODE", "UPDATE_NODE_LABEL"),
           ("NODE", "UPDATE_NODE_TAINT"), ("POD", "DELETE"),
           ("POD", "UPDATE"), ("POD", "ADD"))
_PLUGIN_SETS = ((), ("NodeResourcesFit",), ("NodeAffinity",),
                ("Coscheduling",), ("NodeAffinity", "NodeResourcesFit"))


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _event(ev_mod, gvk: str, action: str):
    return ev_mod.ClusterEvent(getattr(ev_mod.GVK, gvk),
                               getattr(ev_mod.ActionType, action))


def scripted_queue_run(side: str, seed: int):
    """One seeded script on ``side``'s queue: returns the log of pop
    orders and ``stats()`` after every step."""
    objs, ev_mod, Queue, QPI, PodInfo = SIDES[side]
    rng = np.random.default_rng(seed)
    event_map = {}
    ev_mod.merge_event_registrations(
        ((name, [_event(ev_mod, g, a) for g, a in evs])
         for name, evs in _REGISTRATIONS), event_map)
    clock = FakeClock()
    q = Queue(event_map=event_map, clock=clock)
    pods = {}
    n = 0

    def new_pods(k: int):
        nonlocal n
        out = []
        for _ in range(k):
            if rng.random() < 0.25:
                size = int(rng.integers(2, 5))
                members = objs.make_gang_pods(f"g{n}", size)
            else:
                members = [objs.make_pod(f"p{n}")]
            for p in members:
                p.metadata.uid = f"pod-{n:08d}"
                n += 1
                pods[p.metadata.uid] = p
                out.append(p)
        return out

    log = []
    in_flight = []  # popped, not yet resolved
    for step in range(60):
        op = rng.choice(["add", "add_batch", "pop", "resolve", "event",
                         "move_request", "clock", "flush", "update",
                         "delete"], p=[.12, .08, .2, .2, .12, .04, .1, .06,
                                       .04, .04])
        if op == "add":
            for p in new_pods(1):
                q.add(p)
        elif op == "add_batch":
            q.add_batch(new_pods(int(rng.integers(2, 6))))
        elif op == "pop":
            batch = q.pop_batch(int(rng.integers(2, 7)), timeout=0.01,
                                gather_backoff_s=0.0)
            log.append(("pop", [(b.pod.metadata.name, b.attempts,
                                 b.scheduling_cycle) for b in batch]))
            in_flight.extend(batch)
        elif op == "resolve" and in_flight:
            qpi = in_flight.pop(int(rng.integers(len(in_flight))))
            how = rng.random()
            if how < 0.6:
                qpi.unschedulable_plugins = set(
                    _PLUGIN_SETS[int(rng.integers(len(_PLUGIN_SETS)))])
                q.add_unschedulable(qpi)
            elif how < 0.8:
                q.observe_bind(qpi.pod, "n0")
            else:
                q.add(qpi.pod, requeue=True)
        elif op == "event":
            g, a = _EVENTS[int(rng.integers(len(_EVENTS)))]
            q.move_all_to_active_or_backoff(_event(ev_mod, g, a))
        elif op == "move_request":
            q.note_move_request(_event(ev_mod, "POD", "UPDATE"))
        elif op == "clock":
            clock.t += float(rng.choice([0.5, 1.0, 3.0, 70.0]))
        elif op == "flush":
            q.flush_backoff_completed()
            q.flush_unschedulable_leftover()
        elif op == "update" and pods:
            uid = sorted(pods)[int(rng.integers(len(pods)))]
            old = pods[uid]
            new = old.clone()
            new.metadata.labels["step"] = str(step)
            pods[uid] = new
            q.update(old, new)
        elif op == "delete" and pods:
            uid = sorted(pods)[int(rng.integers(len(pods)))]
            q.delete(pods.pop(uid))
        log.append((str(op), q.stats()))
    # drain what is left, to compare the final order too
    clock.t += 1000.0
    q.flush_unschedulable_leftover()
    q.flush_backoff_completed()
    rest = q.pop_batch(10_000, timeout=0.01, gather_backoff_s=0.0)
    log.append(("drain", [b.pod.metadata.name for b in rest], q.stats()))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_scripted_queue_matches_jax(seed):
    got = scripted_queue_run("port", seed)
    want = scripted_queue_run("jax", seed)
    assert got == want
    pops = [e[1] for e in want if e[0] == "pop"]
    assert any(len(b) > 1 for b in pops)


@pytest.mark.parametrize("side", ["jax", "port"])
def test_pop_batch_completes_and_groups_gangs(side):
    """A wave that pops one member of a gang takes the whole gang, past
    the wave size, and the members end adjacent."""
    objs, _, Queue, _, _ = SIDES[side]
    q = Queue()
    order = [objs.make_pod("a")] + objs.make_gang_pods("g", 3) + [
        objs.make_pod("b")] + objs.make_gang_pods("h", 2)
    for p in order:
        q.add(p)
    first = [qpi.pod.metadata.name for qpi in q.pop_batch(2, timeout=0.1)]
    assert first == ["a", "g-0", "g-1", "g-2"]
    second = [qpi.pod.metadata.name for qpi in q.pop_batch(2, timeout=0.1)]
    assert second == ["b", "h-0", "h-1"]


def _event_map(side: str, cfg):
    registry, enqueue, ev_mod = (
        (jregistry, j_enqueue, jevents) if side == "jax"
        else (tregistry, t_enqueue, tevents))
    chains = registry.build_plugins(cfg)
    plugins = {id(p): p for p in (chains.filter + chains.pre_score
                                  + chains.score + chains.reserve
                                  + chains.permit)}
    event_map = {}
    ev_mod.merge_event_registrations(
        ((p.name(), p.events_to_register()) for p in plugins.values()
         if enqueue(p)), event_map)
    return {(ev.resource.value, int(ev.action_type), ev.label):
            frozenset(names) for ev, names in event_map.items()}


@pytest.mark.parametrize("roster", ["default_scheduler_config",
                                    "default_full_roster_config",
                                    "gang_roster_config"])
def test_event_map_matches_jax(roster):
    """The engine's event map from each package's plugin registrations,
    key for key (a missing registration would leave pods parked until the
    30 s leftover flush)."""
    got = _event_map("port", getattr(tconfig, roster)())
    want = _event_map("jax", getattr(jconfig, roster)())
    assert got == want
    assert got  # every roster registers something


def test_engine_event_map_is_the_registrations():
    """The live engine builds its map from the same registrations."""
    from minisched_tpu_torch.controlplane.client import Client
    from minisched_tpu_torch.controlplane.informer import SharedInformerFactory
    from minisched_tpu_torch.engine.device_scheduler import new_device_scheduler

    client = Client()
    cfg = tconfig.gang_roster_config()
    sched = new_device_scheduler(client, SharedInformerFactory(client.store),
                                 cfg, device="cpu")
    got = {(ev.resource.value, int(ev.action_type), ev.label):
           frozenset(names) for ev, names in sched.event_map.items()}
    assert got == _event_map("port", cfg)
    # config 5's special pods fail NodeAffinity: a node label update must
    # wake them
    label = tevents.ClusterEvent(tevents.GVK.NODE,
                                 tevents.ActionType.UPDATE_NODE_LABEL)
    assert tevents.event_helps_pod(label, {"NodeAffinity"}, sched.event_map)
