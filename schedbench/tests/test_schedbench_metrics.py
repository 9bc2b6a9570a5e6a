"""The arithmetic of the end-to-end metrics and of the trace readings."""

import math

import numpy as np
import pytest

from schedbench.devtrace import TraceData, _busy_and_gaps
from schedbench.harness import end_to_end, p99
from schedbench.roofline import least_seconds, node_width, select_work
from schedbench.spans import flat_timeline, self_times


def test_rate_counts_every_bind_in_the_window():
    # created before the window, bound inside: counted in the rate, not
    # in the tail; bound after the window: in the tail, not in the rate
    created = {"a": 0.5, "b": 1.0, "c": 2.0, "d": 3.0}
    seen = {"a": 1.5, "b": 1.8, "c": 4.5, "d": 2.9 + 0.2}
    rate, tail, attempted, failed = end_to_end(2.0, created, seen, 1.0, 3.0)
    assert rate == pytest.approx(2 / 2.0)  # a and b
    assert attempted == 2 and failed == 0  # b and c (d is at t_end)
    assert tail == pytest.approx(2.5)  # c's wait, the larger of 0.8, 2.5


def test_unbound_pod_is_failed_and_beyond_any_limit():
    created = {f"p{i}": 0.0 for i in range(100)}
    seen = {f"p{i}": 1.0 for i in range(98)}
    rate, tail, attempted, failed = end_to_end(1.0, created, seen, 0.0, 1.0)
    assert rate == 0.0  # bound at 1.0 = t_end, outside [t0, t_end)
    assert attempted == 100 and failed == 2
    assert math.isinf(tail)  # the 99th of 100 is unbound
    seen["p98"] = 0.5
    assert end_to_end(1.0, created, seen, 0.0, 1.0)[1] == 1.0


def test_p99_by_nearest_rank():
    assert p99(list(range(1, 101))) == 99
    assert p99(list(range(1, 201))) == 198
    assert p99([5.0]) == 5.0
    assert math.isnan(p99([]))


def test_self_time_subtracts_nested_spans():
    t = 7
    spans = [("scan_flush", 0.0, 10.0, t), ("scan_build", 1.0, 3.0, t),
             ("constraints_lock_wait", 1.5, 2.0, t),
             ("scan_evaluate", 3.0, 8.0, t), ("bind", 8.5, 9.0, t),
             ("loop_pop", 10.0, 12.0, t), ("other", 0.0, 10.0, 8)]
    st = self_times(spans, [(0.0, 20.0)])
    assert st["scan_flush"] == pytest.approx(10 - 2 - 5 - 0.5)
    assert st["scan_build"] == pytest.approx(1.5)
    assert st["scan_evaluate"] == pytest.approx(5.0)
    assert st["other"] == pytest.approx(10.0)  # another thread
    # only spans that end inside the intervals count
    assert "loop_pop" not in self_times(spans, [(0.0, 11.0)])


def test_idle_gaps_are_named_by_the_innermost_engine_span():
    t = 1
    spans = [("scan_flush", 0.0, 10.0, t), ("scan_build", 1.0, 3.0, t),
             ("loop_pop", 10.0, 12.0, t)]
    pieces = flat_timeline(spans, t)
    assert pieces == [(0.0, 1.0, "scan_flush"), (1.0, 3.0, "scan_build"),
                      (3.0, 10.0, "scan_flush"), (10.0, 12.0, "loop_pop")]
    trace = TraceData(12.0, 0.0, {}, [],
                      np.array([[1.5, 2.5], [5.0, 6.0], [11.0, 11.5]]))
    assert trace.idle_by_span(pieces) == {"scan_build": 1.0,
                                          "scan_flush": 1.0,
                                          "loop_pop": 0.5}


def test_busy_is_the_union_of_operations_within_the_window():
    starts = np.array([0, 5, 6, 20, 95], np.int64)
    ends = np.array([10, 8, 12, 30, 120], np.int64)
    busy, gaps = _busy_and_gaps(starts, ends, 2, 100)
    assert busy == (12 - 2) + (30 - 20) + (100 - 95)
    assert gaps.tolist() == [[12, 20], [30, 95]]


def test_roofline_work_of_select_hosts():
    assert node_width(10_000) == 10_112 and node_width(5_000) == 5_120
    nbytes, ops = select_work(1, 10_112, 1)
    assert nbytes == 10_112 * 5 + 12 and ops == 2 * 10_112 + 11
    t, bound = least_seconds(1, 10_112, 1)
    assert bound == "bytes" and t == pytest.approx(nbytes / 3.35e12)
