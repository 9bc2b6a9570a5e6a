"""The cluster and the traffic are made from the seed, the same each
time, with the same sizes on every seed."""

import json

import numpy as np
import pytest

from schedbench.cluster import PodTemplate, make_cluster
from schedbench.spec import PACKAGE_DIR, _load, find_cell

from .conftest import REPO

SEED = 2**31 + 12345  # past 32 signed bits, as the driver's are
#: the configuration files (``c5-10k`` is kept for a later cell)
CONFIGS = ["c5-10k", "k8s-5k"]
recreate = _load(PACKAGE_DIR / "generators" / "recreate.py")
TRAFFIC = json.loads((PACKAGE_DIR / "traffic" / "spread-recreate.json")
                     .read_text())


def _config(name):
    return json.loads((PACKAGE_DIR / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", CONFIGS)
def test_cluster_is_deterministic_from_the_seed(name):
    config = _config(name)
    a, b = make_cluster(config, SEED), make_cluster(config, SEED)
    c = make_cluster(config, SEED + 1)
    assert a.names == b.names and a.initial == b.initial
    assert a.labels == c.labels  # the layout is the seed's to keep
    # another seed: other draws, the same sizes
    assert len(a.initial) == len(c.initial) == \
        config["initial_pods"]["count"]
    assert a.initial != c.initial


@pytest.mark.parametrize("name", CONFIGS)
def test_nodes_carry_hostname_and_zone(name):
    config = _config(name)
    cl = make_cluster(config, SEED)
    assert cl.labels["kubernetes.io/hostname"] == cl.names
    zones = cl.labels["topology.kubernetes.io/zone"]
    assert sorted(set(zones)) == ["moon-1", "moon-2", "moon-3"]
    counts = [zones.count(z) for z in ("moon-1", "moon-2", "moon-3")]
    assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("name", CONFIGS)
def test_initial_pods_fit_their_nodes(name):
    config = _config(name)
    cl = make_cluster(config, SEED)
    rows = np.array([r for _n, r in cl.initial])
    per_node = np.bincount(rows, minlength=len(cl.names))
    assert (per_node * cl.initial_pod.cpu_m <= cl.cpu_m).all()
    assert (per_node * cl.initial_pod.memory_mib <= cl.memory_mib).all()
    assert (per_node <= cl.pods).all()


def test_negative_and_huge_seeds_are_folded():
    config = find_cell(REPO, "k8s-5k.spread-recreate").config
    make_cluster(config, -5)
    make_cluster(config, 2**70)
    pod = PodTemplate(1, 1)
    assert recreate.rollout(0, 2, -1, pod)[0].uid != \
        recreate.rollout(0, 2, 1, pod)[0].uid


def test_traffic_is_deterministic_and_names_are_unique():
    pod = PodTemplate.from_json(TRAFFIC["pod"])
    a = recreate.rollout(7, 4, SEED, pod)
    assert a == recreate.rollout(7, 4, SEED, pod)
    assert a != recreate.rollout(7, 4, SEED + 1, pod)  # uids, not sizes
    assert [p.name for p in a] == [
        p.name for p in recreate.rollout(7, 4, 0, pod)]
    assert len({p.name for p in a}) == 4
    assert a[0].pod.labels == (("foo", "bar"),)
    assert [c.topology_key for c in a[0].pod.spread] == [
        "kubernetes.io/hostname", "topology.kubernetes.io/zone"]
    assert all(c.hard and c.max_skew == 5 for c in a[0].pod.spread)


def _bind_all(loop, actions):
    out = []
    for kind, plans in actions:
        if kind == "create":
            for p in plans:
                out += loop.on_bound(p.name)
    return out


def test_recreate_deletes_the_last_rollout_before_the_next():
    loop = recreate.make(dict(TRAFFIC, replicas=3), 1)
    actions = loop.start()
    assert [k for k, _p in actions] == ["create"]
    first = actions[0][1]
    actions = _bind_all(loop, actions)
    assert [k for k, _p in actions] == ["delete", "create"]
    assert actions[0][1] == first
    assert loop.completed == 1 and loop.in_flight() == 3
    # a pod of an older rollout bound late moves nothing
    assert loop.on_bound(first[0].name) == [] and loop.in_flight() == 3


def test_budget_holds_and_release_goes_on():
    loop = recreate.make(dict(TRAFFIC, replicas=1), 1)
    loop.budget = 1
    actions = loop.start()
    assert _bind_all(loop, actions) == []
    assert loop.holding and loop.in_flight() == 0
    loop.budget = None
    actions = loop.release()
    assert [k for k, _p in actions] == ["delete", "create"]
    loop.allow_new = False  # the window's end
    assert _bind_all(loop, actions) == []
    assert loop.holding and loop.completed == 2
