"""The port's per-namespace admission quota and the rest of the queue, against
the JAX package's.

The quota tests of ``tests/test_churn.py`` run here on the port's
``SchedulingQueue``: over-cap arrivals held and promoted FIFO, requeues
and gang members bypassing the hold, a held pod never tracked twice, a
pod deleted while held purged, a tenant's share of one ``pop_batch``
bounded by its cap, promotions deferred while a gather is open, and the
gather-backoff branch.  (Its store test of bounded watch queues waits for
the port of the store's evicting queues, ROADMAP item 6.)  Beside them:
one seeded sequence of adds, batch pops, requeues, unschedulable returns
and deletes over three tenants with gangs gives the same popped order,
the same ``stats()`` and ``quota_stats()`` and the same counters on both
queues; ``assigned_pod_added``/``assigned_pod_updated`` move the same
parked pods; ``pending_unschedulable`` lists them; and the scalar
``Scheduler``'s ``run_filter_plugins``, ``run_pre_score_plugins`` and
``run_score_plugins`` wrappers answer as JAX's.
"""

from __future__ import annotations

import random

import pytest

from minisched_tpu.api import objects as jobj
from minisched_tpu.framework import events as jevents
from minisched_tpu.framework import types as jtypes
from minisched_tpu.observability import counters as jcounters
from minisched_tpu.queue import queue as jqueue

from minisched_tpu_torch.api import objects as tobj
from minisched_tpu_torch.api.objects import make_gang_pods
from minisched_tpu_torch.framework import events as tevents
from minisched_tpu_torch.framework import types as ttypes
from minisched_tpu_torch.framework.types import PodInfo, QueuedPodInfo
from minisched_tpu_torch.observability import counters
from minisched_tpu_torch.queue import queue as tqueue
from minisched_tpu_torch.queue.queue import SchedulingQueue

QUOTA_COUNTERS = ("queue.quota_held", "queue.quota_admitted",
                  "queue.quota_gang_bypass", "queue.quota_violation")


def _pod(name, ns, uid=None, gang=None, objs=tobj):
    p = objs.make_pod(name, namespace=ns, requests={"cpu": "1"})
    p.metadata.uid = uid or name
    if gang is not None:
        p.spec.gang = gang
    return p


# -- the JAX tests, on the port --------------------------------------------


def test_quota_holds_over_cap_and_promotes_fifo():
    q = SchedulingQueue(namespace_quota={"ten-a": 2, "*": 3})
    for i in range(5):
        q.add(_pod(f"a{i}", "ten-a"))
    assert q.stats()["active"] == 2
    assert q.stats()["quota_held"] == 3
    assert q.quota_stats()["ten-a"] == {"admitted": 2, "held": 3, "limit": 2}
    got = q.pop(timeout=0.1)
    assert got.pod.metadata.name == "a0"
    assert q.quota_stats()["ten-a"]["admitted"] == 2
    names = [q.pop(timeout=0.1).pod.metadata.name for _ in range(2)]
    assert names == ["a1", "a2"]
    for i in range(5):
        q.add(_pod(f"b{i}", "ten-b"))
    assert q.quota_stats()["ten-b"] == {"admitted": 3, "held": 2, "limit": 3}


def test_quota_requeues_bypass_hold():
    q = SchedulingQueue(namespace_quota={"ten-a": 1})
    q.add(_pod("a0", "ten-a"))
    qpi = q.pop_batch(1, timeout=0.1)[0]
    q.add(_pod("a1", "ten-a"))
    q.add_unschedulable(qpi)
    st = q.quota_stats()["ten-a"]
    assert st["admitted"] == 2 and st["held"] == 0


def test_quota_requeue_via_add_bypasses_hold():
    q = SchedulingQueue(namespace_quota={"ten-a": 1})
    q.add(_pod("a0", "ten-a"))
    popped = q.pop(timeout=0.1)
    q.add(_pod("a1", "ten-a"))
    q.add(popped.pod, requeue=True)
    assert q.quota_stats()["ten-a"] == {"admitted": 2, "held": 0, "limit": 1}
    names = {q.pop(timeout=0.1).pod.metadata.name for _ in range(2)}
    assert names == {"a0", "a1"}


def test_quota_held_pod_never_double_tracked():
    q = SchedulingQueue(namespace_quota={"ten-a": 1})
    q.add(_pod("a0", "ten-a"))
    held = _pod("a1", "ten-a")
    q.add(held)
    assert q.stats()["quota_held"] == 1
    q.add_unschedulable(QueuedPodInfo(PodInfo(held)))
    assert q.stats()["quota_held"] == 1
    assert q.stats()["unschedulable"] == 0
    q.pop(timeout=0.1)
    assert q.pop(timeout=0.1).pod.metadata.name == "a1"
    assert q.pop(timeout=0.1) is None
    assert q.quota_stats().get("ten-a", {}).get("admitted", 0) == 0


def test_quota_deleted_while_held_is_purged():
    q = SchedulingQueue(namespace_quota={"ten-a": 1})
    a0, a1, a2 = (_pod(f"a{i}", "ten-a") for i in range(3))
    for p in (a0, a1, a2):
        q.add(p)
    assert q.stats()["quota_held"] == 2
    q.delete(a1)
    q.pop(timeout=0.1)
    assert q.pop(timeout=0.1).pod.metadata.name == "a2"
    assert q.stats()["quota_held"] == 0


def test_quota_wave_share_bounded():
    violations = counters.get("queue.quota_violation")
    q = SchedulingQueue(namespace_quota={"ten-a": 2})
    for i in range(6):
        q.add(_pod(f"a{i}", "ten-a"))
    waves = []
    while True:
        batch = q.pop_batch(10, timeout=0.1)
        if not batch:
            break
        waves.append([qpi.pod.metadata.name for qpi in batch])
    assert waves == [["a0", "a1"], ["a2", "a3"], ["a4", "a5"]]
    assert counters.get("queue.quota_violation") == violations


def test_pop_batch_gather_backoff_branch():
    q = SchedulingQueue(initial_backoff_s=0.15)
    q.add(_pod("b0", "default"))
    qpi = q.pop(timeout=0.2)
    q.note_move_request(None)
    q.add_unschedulable(qpi)
    assert q.stats()["backoff"] == 1
    q.add(_pod("a0", "default"))
    batch = q.pop_batch(5, timeout=0.5, gather_backoff_s=0.35)
    assert sorted(x.pod.metadata.name for x in batch) == ["a0", "b0"]


def test_quota_promotion_deferred_during_gather():
    q = SchedulingQueue(namespace_quota={"ten-a": 1})
    q.add(_pod("a0", "ten-a"))
    q.add(_pod("a1", "ten-a"))
    with q._cond:
        q._deferred_promos = []
    q.delete(_pod("a0", "ten-a"))
    st = q.stats()
    assert st["quota_held"] == 1 and st["active"] == 0
    with q._cond:
        pending, q._deferred_promos = q._deferred_promos, None
        for ns in pending:
            q._promote_held_locked(ns)
    st = q.stats()
    assert st["active"] == 1 and st["quota_held"] == 0


def test_quota_gang_members_never_split():
    q = SchedulingQueue(namespace_quota={"ten-g": 2})
    q.add(_pod("g-pre", "ten-g"))
    q.add(_pod("g-pre2", "ten-g"))
    before = counters.get("queue.quota_gang_bypass")
    for p in make_gang_pods("train", 4, namespace="ten-g"):
        p.metadata.uid = p.metadata.name
        q.add(p)
    assert counters.get("queue.quota_gang_bypass") == before + 4
    assert q.stats()["quota_held"] == 0
    assert len(q.pop_batch(16, timeout=0.1)) == 6


def test_no_quota_changes_nothing():
    """With ``namespace_quota`` unset the queue keeps no quota state: no
    ``quota_held`` in ``stats()``, an empty ``quota_stats()``, and the
    FIFO order of every earlier slice."""
    q = SchedulingQueue()
    for i in range(5):
        q.add(_pod(f"a{i}", f"ten-{i % 2}"))
    assert "quota_held" not in q.stats() and q.quota_stats() == {}
    assert [x.pod.metadata.name for x in q.pop_batch(10, timeout=0.1)] == \
        [f"a{i}" for i in range(5)]


# -- one seeded sequence, port against JAX ---------------------------------

SIDES = {
    "jax": (jobj, jqueue, jtypes, jevents, jcounters),
    "port": (tobj, tqueue, ttypes, tevents, counters),
}


def _sequence(side, seed):
    """Adds over three tenants (gangs in one), batch pops of random size,
    requeues, unschedulable returns, deletes and moves, from one seed.
    Returns every popped batch, every ``stats()``/``quota_stats()`` and
    the quota counters' deltas."""
    objs, qmod, types, events, ctr = SIDES[side]
    rng = random.Random(seed)
    base = {c: ctr.get(c) for c in QUOTA_COUNTERS}
    q = qmod.SchedulingQueue(
        namespace_quota={"ten-a": 2, "ten-b": 1, "*": 2},
        initial_backoff_s=60.0)
    made, popped, log = 0, [], []
    for _step in range(80):
        op = rng.random()
        if op < 0.45:
            ns = rng.choice(["ten-a", "ten-b", "ten-c", "ten-g"])
            if ns == "ten-g" and rng.random() < 0.5:
                for p in objs.make_gang_pods(f"gang{made}", 3, namespace=ns):
                    p.metadata.uid = p.metadata.name
                    q.add(p)
            else:
                q.add(_pod(f"p{made:03d}", ns, objs=objs))
            made += 1
        elif op < 0.7:
            batch = q.pop_batch(rng.randrange(1, 6), timeout=0.01,
                                gather_backoff_s=0.0)
            log.append(("pop", [x.pod.metadata.name for x in batch]))
            popped.extend(batch)
        elif op < 0.8 and popped:
            qpi = popped.pop(rng.randrange(len(popped)))
            if rng.random() < 0.5:
                q.add(qpi.pod, requeue=True)
            else:
                qpi.unschedulable_plugins = {"NodeResourcesFit"}
                q.add_unschedulable(qpi)
        elif op < 0.9:
            pending = [p.pod for p in popped] + [
                qpi.pod for qpi in q.pending_unschedulable()]
            if pending:
                q.delete(pending[rng.randrange(len(pending))])
            elif made:
                q.delete(_pod(f"p{rng.randrange(made):03d}",
                              rng.choice(["ten-a", "ten-b"]), objs=objs))
        elif op < 0.95:
            q.assigned_pod_added(None)
        else:
            q.assigned_pod_updated(None)
        log.append(("stats", q.stats(), q.quota_stats(),
                    sorted(x.pod.metadata.name
                           for x in q.pending_unschedulable())))
    while True:
        batch = q.pop_batch(8, timeout=0.01, gather_backoff_s=0.0)
        if not batch:
            break
        log.append(("drain", [x.pod.metadata.name for x in batch]))
    log.append(("counters", {c: ctr.get(c) - base[c]
                             for c in QUOTA_COUNTERS}))
    return log


@pytest.mark.parametrize("seed", range(4))
def test_seeded_sequence_equal_to_jax(seed):
    got = _sequence("port", seed)
    want = _sequence("jax", seed)
    assert got == want
    assert want[-1][1]["queue.quota_held"] > 0
    assert want[-1][1]["queue.quota_violation"] == 0


def test_assigned_pod_events_move_as_jax():
    """A parked pod with no recorded failing plugin (it retries on any
    event) moves back on ``assigned_pod_added`` and
    ``assigned_pod_updated``; one whose failing plugin registered no Pod
    event (an empty event map) stays, on both queues;
    ``pending_unschedulable`` lists the parked pods."""
    out = []
    for side in ("jax", "port"):
        objs, qmod, types, _events, _ctr = SIDES[side]
        q = qmod.SchedulingQueue()
        seen = []
        for method in ("assigned_pod_added", "assigned_pod_updated"):
            for name, failed in (("any", set()),
                                 ("fit", {"NodeResourcesFit"})):
                pod = _pod(f"{method}-{name}", "default", objs=objs)
                q.add(pod)
                qpi = q.pop(timeout=0.1)
                qpi.unschedulable_plugins = failed
                q.add_unschedulable(qpi)
            parked = sorted(x.pod.metadata.name
                            for x in q.pending_unschedulable())
            getattr(q, method)(None)
            seen.append((parked, q.stats(),
                         sorted(x.pod.metadata.name
                                for x in q.pending_unschedulable())))
        out.append(seen)
    assert out[0] == out[1]
    assert out[1][0][0] != out[1][0][2]


def test_scheduler_plugin_wrappers_as_jax():
    """``Scheduler.run_filter_plugins`` / ``run_pre_score_plugins`` /
    ``run_score_plugins`` on a scalar scheduler of the full roster answer
    as JAX's on the same node infos."""
    from minisched_tpu.controlplane.client import Client as JClient
    from minisched_tpu.controlplane.informer import (
        SharedInformerFactory as JFactory,
    )
    from minisched_tpu.engine import scheduler as jsched
    from minisched_tpu.framework.nodeinfo import build_node_infos as jinfos
    from minisched_tpu.plugins.registry import build_plugins as jplugins
    from minisched_tpu.service import config as jconfig

    from minisched_tpu_torch.controlplane.client import Client
    from minisched_tpu_torch.controlplane.informer import SharedInformerFactory
    from minisched_tpu_torch.engine import scheduler as tsched
    from minisched_tpu_torch.framework.nodeinfo import build_node_infos
    from minisched_tpu_torch.plugins.registry import build_plugins
    from minisched_tpu_torch.service import config as tconfig

    from tests.test_torch_engine import overflow_cluster

    results = []
    for objs, client, factory, mod, plugins, infos_of, config, types in (
            (jobj, JClient(), JFactory, jsched, jplugins, jinfos,
             jconfig, jtypes),
            (tobj, Client(), SharedInformerFactory, tsched, build_plugins,
             build_node_infos, tconfig, ttypes)):
        nodes, pods = overflow_cluster(objs, seed=2, n_nodes=8, n_pods=6)
        cfg = config.default_full_roster_config()
        chains = plugins(cfg)
        sched = mod.Scheduler(client, factory(client.store),
                    filter_plugins=chains.filter,
                    pre_score_plugins=chains.pre_score,
                    score_plugins=chains.score, permit_plugins=[],
                    score_weights=cfg.score_weights())
        infos = infos_of(nodes, [])
        per_pod = []
        for pod in pods:
            state = types.CycleState()
            for ni in infos:  # the snapshot lister, as schedule_pod_once
                state.write("nodeinfo/" + ni.name, ni)
            state.write("nodeinfos", infos)
            mod.run_pre_filter_plugins(chains.filter, state, pod, infos)
            feasible, diagnosis = sched.run_filter_plugins(state, pod, infos)
            names = [ni.name for ni in feasible]
            status = sched.run_pre_score_plugins(
                state, pod, [ni.node for ni in feasible])
            scores = sched.run_score_plugins(state, pod, names)
            per_pod.append((names, sorted(diagnosis.node_to_status),
                            status.is_success(), scores))
        results.append(per_pod)
    assert results[0] == results[1]
    assert any(r[3] for r in results[1])
