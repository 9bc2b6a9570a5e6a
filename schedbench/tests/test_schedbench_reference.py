"""The reference on clusters small enough to work out by hand, and the
comparison's counts."""

import numpy as np

from schedbench.check import LIMITS, control_events, judge, passed
from schedbench.cluster import Cluster, PodTemplate, Spread
from schedbench.reference import Reference, mix32, pod_seed

ZONE = "zone"
HOST = "kubernetes.io/hostname"
APP = (("app", "a"),)


def spread(key=ZONE, skew=1):
    return Spread(key, skew, "DoNotSchedule", APP)


def pod(cpu=1000, mem=1024, labels=APP, constraints=(spread(),)):
    return PodTemplate(cpu, mem, labels, tuple(constraints))


PLAIN = PodTemplate(1000, 1024)


def cluster(n=4, zones=2, cpu=4000, mem=4096, pods=110, initial=()):
    names = [f"n{i}" for i in range(n)]
    return Cluster(
        names=names, cpu_m=np.full(n, cpu, np.int64),
        memory_mib=np.full(n, mem, np.int64),
        pods=np.full(n, pods, np.int64),
        labels={HOST: list(names),
                ZONE: [f"z{i % zones}" for i in range(n)]},
        namespace="default", initial_pod=PLAIN, initial=list(initial))


def test_fnv_and_mix32_known_values():
    # FNV-1a of "" is the offset basis; of "a" the published 0xe40c292c
    assert pod_seed("") == 0x811C9DC5
    assert pod_seed("a") == 0xE40C292C
    # mix32(0, 0): every step of 0 stays 0
    assert int(mix32(0, np.array([0]))[0]) == 0
    x = (1 * 0x9E3779B9) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    x ^= x >> 16
    assert int(mix32(0, np.array([1]))[0]) == x


def test_scores_by_hand():
    # an empty 4,000m / 4,096 Mi node, one pod of 1,000m / 1,024 Mi:
    # LeastAllocated ((3000*100//4000) + (3072*100//4096)) // 2 = 75;
    # fractions 2,500 and 2,500: balanced 100
    ref = Reference(cluster(n=1, zones=1))
    assert ref.scores(PLAIN).tolist() == [175]
    # with two such pods on it: cpu 3,000 and mem 3,072 requested with
    # the next — LA (25 + 25) // 2 = 25; fractions equal: balanced 100
    ref.add("x", 0, PLAIN)
    ref.add("y", 0, PLAIN)
    assert ref.scores(PLAIN).tolist() == [((1000 * 100 // 4000)
                                           + (1024 * 100 // 4096)) // 2
                                          + 100]
    # an uneven pod: 2,000m / 512 Mi on the empty node: LA (50 + 87) // 2
    # = 68; fractions 5,000 and 1,250: balanced 62
    empty = Reference(cluster(n=1, zones=1))
    assert empty.scores(PodTemplate(2000, 512)).tolist() == [68 + 62]


def test_emptier_node_wins_and_ties_go_by_the_hash():
    ref = Reference(cluster(n=4, zones=1, initial=[("i0", 0), ("i1", 1)]))
    uid = "pod-a"
    want = min((2, 3), key=lambda r: (int(mix32(pod_seed(uid),
                                                 np.array([r]))[0]), r))
    assert ref.choose(uid, pod()) == want


def test_full_nodes_are_never_chosen():
    ref = Reference(cluster(n=3, zones=1, pods=1,
                            initial=[("i0", 0), ("i1", 1)]))
    assert ref.choose("p", pod()) == 2
    ref.add("p", 2, pod())
    assert ref.choose("q", pod()) == -1


def test_zone_spread_keeps_the_skew():
    # two zones, skew 1: after one pod in z0, the next must go to z1
    ref = Reference(cluster(n=4, zones=2))
    first = ref.choose("p0", pod())
    ref.add("p0", first, pod())
    second = ref.choose("p1", pod())
    assert second % 2 != first % 2
    # pods the selector does not match neither count nor are held
    other = PodTemplate(1000, 1024, (("app", "b"),),
                        (Spread(ZONE, 1, "DoNotSchedule", (("app", "b"),)),))
    assert ref.spread_ok(other).all()


def test_hostname_spread_counts_each_node_alone():
    # one zone, hostname skew 1: with one matching pod on n0 the others
    # hold none, so n0 is out until every node has one
    ref = Reference(cluster(n=3, zones=1, cpu=16000, mem=16384))
    host = pod(constraints=(spread(HOST, 1),))
    ref.add("p0", 0, host)
    assert ref.spread_ok(host).tolist() == [False, True, True]
    ref.add("p1", 1, host)
    ref.add("p2", 2, host)
    assert ref.spread_ok(host).all()
    # a pod the selector does not match itself adds no one to a domain
    stranger = PodTemplate(1000, 1024, (), (spread(HOST, 1),))
    ref.add("p3", 0, host)
    assert ref.spread_ok(stranger).tolist() == [True, True, True]
    assert ref.spread_ok(host).tolist() == [False, True, True]


def test_a_node_without_the_key_is_rejected():
    cl = cluster(n=2, zones=1)
    cl.labels["rack"] = ["r0", "r0"]
    ref = Reference(cl)
    assert ref.spread_ok(pod(constraints=(spread("missing"),))).sum() == 0
    assert ref.spread_ok(pod(constraints=(spread("rack"),))).all()


def test_deletes_free_their_node_and_domain():
    ref = Reference(cluster(n=2, zones=2, pods=1))
    ref.add("p0", 0, pod())
    assert ref.choose("q", pod()) == 1
    ref.remove("p0")
    assert ref.fits(pod()).all() and ref.spread_ok(pod()).all()
    ref.remove("never-bound")  # frees nothing


def test_judge_counts_each_fault_once():
    cl = cluster(n=4, zones=2, pods=1)
    ref = Reference(cl)
    p0 = ref.choose("u0", pod())
    plans = {"p0": ("u0", pod()), "p1": ("u1", pod()), "p2": ("u2", pod())}
    good = [("bind", "p0", cl.names[p0])]
    assert judge(cl, {"p0": plans["p0"]}, good,
                 {"p0": cl.names[p0]}) == dict.fromkeys(LIMITS, 0)
    same_zone = next(i for i in range(4) if i != p0 and i % 2 == p0 % 2)
    events = good + [("bind", "p1", cl.names[p0]),  # full node
                     ("bind", "p0", cl.names[same_zone]),  # bound twice
                     ("bind", "p2", cl.names[same_zone])]  # skew 2
    counts = judge(cl, plans, events,
                   {"p0": cl.names[p0], "p1": "", "p2": cl.names[same_zone]})
    assert counts["over_capacity"] == 1
    assert counts["double_bind"] == 1
    assert counts["skew_exceeded"] == 2  # p1 in p0's zone, p2 likewise
    assert counts["placement_mismatch"] == 2  # p1 and p2
    assert counts["readback_mismatch"] == 1  # p1 reads back unbound
    assert counts["unbound"] == 0
    assert not passed(counts)


def test_unbound_pods_fail_and_deleted_ones_do_not():
    cl = cluster()
    plans = {"p0": ("u0", pod()), "p1": ("u1", pod())}
    counts = judge(cl, plans, [("delete", "p1")], {})
    assert counts["unbound"] == 1


def test_controls_break_a_guarantee():
    cl = cluster(n=8, zones=2, cpu=16000, mem=16384)
    order = [("create", f"p{i}", f"u{i}", pod()) for i in range(12)]
    plans = {s[1]: (s[2], s[3]) for s in order}
    for kind in ("spread", "tiebreak"):
        events = control_events(cl, order, kind)
        counts = judge(cl, plans, events, None)
        assert counts["placement_mismatch"] > 0, kind
    # the reference itself in the program's place passes
    ref = Reference(cl)
    events = []
    for _k, name, uid, p in order:
        row = ref.choose(uid, p)
        ref.add(name, row, p)
        events.append(("bind", name, cl.names[row]))
    assert passed(judge(cl, plans, events, None))
