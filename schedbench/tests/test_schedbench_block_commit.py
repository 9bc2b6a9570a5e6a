"""The reader of ``scan.block_commit_share`` (the blocked lane's
``block_commits`` over its ``steps`` in ``scan_stats``) on synthetic
contexts."""

from types import SimpleNamespace

import pytest

from schedbench.spec import PACKAGE_DIR, metric_reader

NAME = "scan.block_commit_share"


def _ctx(lanes):
    return SimpleNamespace(untraced=SimpleNamespace(lanes=lanes, phases={}),
                           traced=None, node_width=5_120)


@pytest.mark.parametrize("commits,want", [(1_900, 1.0), (950, 0.5), (0, 0.0)])
def test_share_is_commits_over_the_blocked_lanes_steps(commits, want):
    ctx = _ctx({"exact": {"steps": 100, "block_commits": 0},
                "blocked": {"steps": 1_900, "block_commits": commits}})
    assert metric_reader(NAME, PACKAGE_DIR)(ctx) == pytest.approx(want)


@pytest.mark.parametrize("lanes", [
    {},  # no lane ran
    {"blocked": {"steps": 0, "block_commits": 0}},  # no block replayed
    {"blocked": {"steps": 1_900, "select_hosts": 1_900}},  # no such counter
])
def test_reader_gives_nothing_without_its_source(lanes):
    assert metric_reader(NAME, PACKAGE_DIR)(_ctx(lanes)) is None
