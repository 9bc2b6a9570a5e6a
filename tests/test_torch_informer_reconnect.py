"""The port's informer reconnect path and bounded watch queues, on the CPU.

The cases of ``tests/test_churn.py`` that hold the per-watcher queue
bound (a slow watcher evicted alone, one oversized batch evicting no
caught-up watcher, the snapshot replay exempt), of
``tests/test_history_budget.py`` (an informer relisting past byte
compaction), and of ``tests/test_faults.py`` that drop a watch stream
(resume, relist on 410, the reconnect's diff) — re-driven without the
fault fabric (its copies with the ``watch.drop`` point are in
``test_torch_faults.py``): the server-side watch is killed as a dropped
stream would die.  Then the relist's diff against
JAX's ``_apply_relist`` on the same two states, the engine's
``assume.revalidate_on_reconnect`` against JAX's, and
``live.run_config5_remote`` at 100 nodes and 1,000 pods: the façade
child SIGKILLed and restarted under the scheduler, no double bind, fsck
clean.
"""

from __future__ import annotations

import random
import threading
import time

import pytest

from minisched_tpu.api import objects as jobj
from minisched_tpu.controlplane import informer as jinformer
from minisched_tpu.controlplane import store as jstore
from minisched_tpu.engine import device_scheduler as jds
from minisched_tpu.observability import counters as jcounters

from minisched_tpu_torch.api import objects as tobj
from minisched_tpu_torch.api.objects import make_node, make_pod
from minisched_tpu_torch.controlplane import informer as tinformer
from minisched_tpu_torch.controlplane import store as tstore
from minisched_tpu_torch.controlplane.client import Client
from minisched_tpu_torch.controlplane.informer import SharedInformerFactory
from minisched_tpu_torch.controlplane.store import ObjectStore
from minisched_tpu_torch.engine import device_scheduler as tds
from minisched_tpu_torch.observability import counters


def wait_for(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


# -- the per-watcher queue bound (tests/test_churn.py) ----------------------


def test_slow_watcher_evicted_not_blocking():
    """A watcher whose queue exceeds the bound dies like a dropped stream
    (counter + end-of-stream) while fast watchers and the mutator are
    untouched; the initial snapshot replay is exempt from the bound."""
    store = ObjectStore(watch_queue_events=8)
    for i in range(20):
        store.create("Pod", make_pod(f"seed{i:02d}"))
    # snapshot replay (20 > bound) must NOT evict: pre-registration
    slow, _ = store.watch("Pod", send_initial=True)
    fast, _ = store.watch("Pod", send_initial=False)
    ev0 = counters.get("watch.fanout.evicted_slow")
    seen = 0
    for i in range(12):  # slow never consumes; fast keeps up
        store.create("Pod", make_pod(f"live{i:02d}"))
        if fast.next(timeout=0.2) is not None:
            seen += 1
    assert slow.stopped
    assert not fast.stopped and seen == 12  # the laggard alone was shed
    assert counters.get("watch.fanout.evicted_slow") == ev0 + 1
    assert slow.next(timeout=0.1) is None  # queue freed, end-of-stream
    # eviction degraded to the standard resume path
    resumed, _ = store.watch("Pod", resume_rv=store.resource_version - 2)
    tail = [resumed.next(timeout=0.5) for _ in range(2)]
    assert all(ev is not None for ev in tail)
    resumed.stop()
    fast.stop()


def test_oversized_batch_does_not_evict_caught_up_watcher():
    """Eviction gates on EXISTING lag: one fanout batch bigger than the
    bound must not kill a caught-up watcher — only a consumer already
    sitting at the bound is a laggard."""
    store = ObjectStore(watch_queue_events=4)
    w, _ = store.watch("Pod", send_initial=False)
    store.create_many("Pod", [make_pod(f"b{i}") for i in range(10)],
                      return_objects=False)
    assert not w.stopped  # zero backlog when the batch landed
    got = 0
    while w.next(timeout=0.2) is not None:
        got += 1
        if got == 10:
            break
    assert got == 10
    # a consumer already AT the bound is evicted by the next batch
    store.create_many("Pod", [make_pod(f"c{i}") for i in range(4)],
                      return_objects=False)
    store.create_many("Pod", [make_pod(f"d{i}") for i in range(2)],
                      return_objects=False)
    assert w.stopped
    w.stop()


def test_snapshot_replay_backlog_exempt_from_eviction():
    """A watcher mid-way through a big snapshot replay must not be
    evicted by its first live events: the bound measures LIVE lag only
    (queued replay is exempt as a backlog, FIFO-drained first)."""
    store = ObjectStore(watch_queue_events=4)
    for i in range(30):  # snapshot 30 ≫ bound 4
        store.create("Pod", make_pod(f"seed{i:02d}"))
    w, _ = store.watch("Pod", send_initial=True)
    for i in range(3):  # live events while the replay sits unconsumed
        store.create("Pod", make_pod(f"live{i}"))
    assert not w.stopped  # 3 live < bound 4; the 30 replay don't count
    names = []
    while (ev := w.next(timeout=0.2)) is not None:
        names.append(ev.obj.metadata.name)
        if len(names) == 33:
            break
    assert len(names) == 33  # replay + live all delivered in order
    # once the replay is consumed, live lag alone evicts as usual
    for i in range(6):
        store.create("Pod", make_pod(f"post{i}"))
    assert w.stopped
    w.stop()


# -- relist past byte compaction (tests/test_history_budget.py) -------------


def _fat_pod(i: int):
    """A pod whose estimated footprint is dominated by labels."""
    return make_pod(f"fat{i:04d}", requests={"cpu": "500m", "memory": "64Mi"},
                    labels={f"label-key-{k}": "v" * 64 for k in range(20)})


def test_informer_relists_past_byte_compaction():
    """An informer that lost its stream while the byte budget compacted
    the gap away falls back to the full relist (410 path) and
    converges."""
    store = ObjectStore(history_events=10_000, history_bytes=32 * 1024)
    client = Client(store)
    factory = SharedInformerFactory(store)
    inf = factory.informer_for("Pod")
    factory.start()
    assert inf.wait_for_cache_sync(5.0)
    inf._watch.kill()
    for i in range(100):
        client.pods().create(_fat_pod(i))
    assert wait_for(lambda: len(inf.lister()) == 100)
    assert inf.reconnects >= 1
    factory.shutdown()


# -- a dropped stream (tests/test_faults.py, without the fabric) ------------


def _started(store, kind="Node"):
    factory = SharedInformerFactory(store)
    inf = factory.informer_for(kind)
    factory.start()
    assert factory.wait_for_cache_sync(5.0)
    return factory, inf


def test_dropped_stream_reconnects_and_delivers_the_missed_node():
    """The watch dies (killed server-side, as a dropped stream) and a node
    is created while it is down: the reconnect delivers it, and the
    informer is live again."""
    store = ObjectStore()
    factory, inf = _started(store)
    inf._watch.kill()
    store.create("Node", make_node("n1"))
    assert wait_for(lambda: [n.metadata.name for n in inf.lister()]
                    == ["n1"])
    assert inf.reconnects >= 1
    assert inf.staleness_s() < 5.0  # live again after the replay
    factory.shutdown()


def test_informer_resumes_from_last_rv_after_drop():
    """A dropped stream reconnects by RESUMING: the server replays only
    the missed tail from the informer's last seen resource_version, with
    no snapshot re-replay and no diff pass."""
    store = ObjectStore()
    factory, inf = _started(store)
    store.create("Node", make_node("n0"))  # seen live: sets the cursor
    assert wait_for(lambda: inf.lister())
    counters.reset()
    inf._watch.kill()
    store.create("Node", make_node("n1"))
    assert wait_for(lambda: {n.metadata.name for n in inf.lister()}
                    == {"n0", "n1"})
    assert inf.reconnects >= 1
    assert inf.resumes >= 1
    assert counters.get("informer.resume") >= 1
    assert counters.get("informer.relist_on_410") == 0
    factory.shutdown()


def test_informer_relists_on_compacted_history_without_dropping_events():
    """A resume whose resource_version was compacted away gets
    HistoryCompacted and the informer falls back to a full relist,
    converging on the whole post-outage state and dropping nothing."""
    store = ObjectStore()
    factory, inf = _started(store)
    store.create("Node", make_node("n0"))
    assert wait_for(lambda: inf.lister())
    counters.reset()
    # the floor is raised first so the verdict is deterministic
    store.set_history_floor(store.resource_version + 1)
    inf._watch.kill()
    store.create("Node", make_node("n1"))
    assert wait_for(lambda: {n.metadata.name for n in inf.lister()}
                    == {"n0", "n1"})
    assert counters.get("informer.relist_on_410") >= 1
    assert inf.reconnects >= 1
    factory.shutdown()


# -- the relist's diff against JAX's --------------------------------------


def _relist_transcript(inf_mod, objs, seed_pods, relisted):
    """The events ``Informer._apply_relist`` delivers going from
    ``seed_pods`` (the cache) to ``relisted`` (the list payload), and the
    cache after."""
    store = (jstore if inf_mod is jinformer else tstore).ObjectStore()
    inf = inf_mod.Informer(store, "Pod")
    for p in seed_pods:
        inf._cache[p.metadata.key] = p
    got = []
    inf.add_event_handlers(inf_mod.ResourceEventHandlers(
        on_batch=lambda evs: got.extend(evs)))
    got.clear()  # the late registrant's replay of the seeded cache
    inf._pending_replays.clear()
    inf._apply_relist(relisted)
    events = [(ev.type.value, ev.obj.metadata.name,
               ev.obj.metadata.resource_version,
               None if ev.old_obj is None
               else ev.old_obj.metadata.resource_version, ev.rv)
              for ev in got]
    cache = sorted((k, o.metadata.resource_version)
                   for k, o in inf._cache.items())
    return events, cache


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_relist_diff_delivers_the_events_jax_delivers(seed):
    """The same two states (a cache and a relist of it where pods were
    added, changed, deleted or kept) give the same events in the same
    order, and the same cache, on both packages."""
    def states(objs):
        r = random.Random(seed)
        cache, listed = [], []
        for i in range(40):
            p = objs.make_pod(f"p{i:03d}")
            p.metadata.resource_version = i + 1
            fate = r.choice(["keep", "change", "delete"])
            cache.append(p)
            if fate == "keep":
                listed.append(p)
            elif fate == "change":
                q = objs.make_pod(f"p{i:03d}")
                q.metadata.resource_version = 100 + i
                listed.append(q)
        for i in range(r.randrange(1, 8)):
            q = objs.make_pod(f"new{i}")
            q.metadata.resource_version = 200 + i
            listed.append(q)
        r.shuffle(listed)
        return cache, listed

    got = _relist_transcript(tinformer, tobj, *states(tobj))
    want = _relist_transcript(jinformer, jobj, *states(jobj))
    assert got == want
    kinds = {e[0] for e in want[0]}
    assert kinds == {"ADDED", "MODIFIED", "DELETED"}


def test_revalidate_on_reconnect_counts_as_jax():
    """A reconnect makes every assumption's lease due at once and counts
    them in ``assume.revalidate_on_reconnect``, on both engines."""

    def count(ds_mod, cnt):
        eng = ds_mod.DeviceScheduler.__new__(ds_mod.DeviceScheduler)
        eng._assumed_lock = threading.Lock()
        eng._assumed_expiry = {f"uid-{i}": 1e12 for i in range(5)}
        before = cnt.get("assume.revalidate_on_reconnect")
        eng._revalidate_assume_ledger()
        due = all(t <= time.monotonic() for t in eng._assumed_expiry.values())
        return cnt.get("assume.revalidate_on_reconnect") - before, due

    assert count(tds, counters) == count(jds, jcounters) == (5, True)


# -- config 5's flow through a façade restart, at a small size --------------


def test_remote_scheduler_rides_through_a_facade_restart(tmp_path):
    """``live.run_config5_remote`` at 100 nodes and 1,000 pods on the CPU
    twins, waves of 32: the façade child is SIGKILLed after 150 watched
    binds and restarted on its port over its WAL; every plain pod ends
    bound once, every watched bind on its node, both informers
    reconnected, no double bind in the WAL, fsck exit 0 (the run raises
    otherwise)."""
    from minisched_tpu_torch.live import run_config5_remote

    run = run_config5_remote(str(tmp_path), 100, 1_000, kill_binds=150,
                             device="cpu", chunk=500, max_wave=32,
                             timeout_s=300)
    assert run.double_binds == 0 and run.fsck_rc == 0
    assert run.seen_at_kill >= 150
    assert run.left_at_boot >= 98
    assert all(v["reconnects"] >= 1 for v in run.reconnects.values())
    assert run.loop_errors == 0 and run.assumed_left == 0
    assert run.audit["nodes"] == 100
    assert run.threads_left == []


@pytest.mark.parametrize("history", [65536, 2])
def test_pod_watch_resumes_or_relists_after_an_eviction(history):
    """``live.PodWatch`` (the chip smoke's test watch) whose stream the
    store kills, as a slow watcher's eviction does, resumes from the last
    rv it saw, or past a compacted history relists: every bind is seen."""
    from minisched_tpu_torch.controlplane.httpserver import start_api_server
    from minisched_tpu_torch.live import PodWatch

    store = ObjectStore(history_events=history)
    client = Client(store)
    client.nodes().create(make_node("n1"))
    _server, base, shutdown = start_api_server(store)
    try:
        watch = PodWatch(base)
        client.pods().create_many([make_pod(f"p{i}") for i in range(6)])
        for i in range(3):
            client.pods().bind(tobj.Binding(f"p{i}", "default", "n1"))
        assert wait_for(lambda: len(watch.bound) == 3)
        with store.locked():
            live_watches = list(store._watches["Pod"])
        for w in live_watches:
            w.kill()
        for i in range(3, 6):
            client.pods().bind(tobj.Binding(f"p{i}", "default", "n1"))
        assert wait_for(lambda: len(watch.bound) == 6)
        assert watch.reconnects >= 1 and watch.error is None
        assert watch.relists == (1 if history == 2 else 0)
        assert watch.nodes == {f"p{i}": "n1" for i in range(6)}
    finally:
        shutdown()
        watch.join()
