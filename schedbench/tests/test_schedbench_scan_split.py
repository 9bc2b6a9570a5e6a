"""The readers of the scan lanes' split (the spans ``scan_prepare``,
``scan_capture``, ``scan_replay`` and the ``scan_stats`` counters
``replays``, ``device_s``, ``capture_s``, ``build_tables_s``,
``build_constraints_s``) on synthetic contexts."""

from types import SimpleNamespace

import pytest

from schedbench.spec import PACKAGE_DIR, metric_reader

SPLIT = ("scan.device_ms_per_step", "scan.capture_ms_per_pod",
         "scan.prepare_ms_per_pod", "scan.build_tables_ms_per_pod",
         "scan.build_constraints_ms_per_pod")


def _ctx(lanes, phases=None):
    return SimpleNamespace(untraced=SimpleNamespace(
        lanes=lanes, phases=phases or {}), traced=None, node_width=5_120)


def _lane(**kw):
    lane = {"calls": 2, "steps": 0, "select_hosts": 0, "capture_s": 0.0,
            "replays": 0, "device_s": 0.0, "placed": 0,
            "build_tables_s": 0.0, "build_constraints_s": 0.0, "rounds": 0,
            "to_exact": 0}
    lane.update(kw)
    return lane


WINDOW = _ctx({"exact": _lane(placed=100, replays=100, device_s=0.05,
                              capture_s=0.01, build_tables_s=0.02,
                              build_constraints_s=0.03),
               "blocked": _lane(placed=1_900, replays=1_900, device_s=1.95,
                                capture_s=0.19, build_tables_s=0.58,
                                build_constraints_s=0.37)},
              {"scan_prepare": {"count": 4, "total_s": 0.4},
               "scan_evaluate": {"count": 4, "total_s": 4.0}})


@pytest.mark.parametrize("name,want", [
    ("scan.device_ms_per_step", 2.0 / 2_000 * 1e3),
    ("scan.capture_ms_per_pod", 0.2 / 2_000 * 1e3),
    ("scan.prepare_ms_per_pod", 0.4 / 2_000 * 1e3),
    ("scan.build_tables_ms_per_pod", 0.6 / 2_000 * 1e3),
    ("scan.build_constraints_ms_per_pod", 0.4 / 2_000 * 1e3),
])
def test_reader_divides_both_lanes_together(name, want):
    assert metric_reader(name, PACKAGE_DIR)(WINDOW) == pytest.approx(want)


@pytest.mark.parametrize("name", SPLIT)
def test_reader_gives_nothing_without_a_divisor(name):
    idle = _ctx({"exact": _lane(), "blocked": _lane()},
                {"scan_prepare": {"count": 0, "total_s": 0.0}})
    assert metric_reader(name, PACKAGE_DIR)(idle) is None
    assert metric_reader(name, PACKAGE_DIR)(_ctx({})) is None


@pytest.mark.parametrize("name", ["scan.device_ms_per_step",
                                  "scan.prepare_ms_per_pod",
                                  "scan.build_tables_ms_per_pod",
                                  "scan.build_constraints_ms_per_pod"])
def test_reader_gives_nothing_where_the_program_lacks_its_source(name):
    """A program without the split (no such counters in ``scan_stats``,
    no ``scan_prepare`` span) gives no value, and no error."""
    old = {"calls": 2, "steps": 2_000, "select_hosts": 2_000,
           "capture_s": 0.2, "placed": 2_000, "rounds": 2, "to_exact": 0}
    ctx = _ctx({"exact": dict(old), "blocked": dict(old)},
               {"scan_evaluate": {"count": 4, "total_s": 4.0}})
    assert metric_reader(name, PACKAGE_DIR)(ctx) is None
