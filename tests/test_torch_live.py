"""The live drivers of ``chip_smoke.py`` phases 17-18 and the ``c5`` bench
role (``minisched_tpu_torch/live.py``), at a small size on the CPU.

Config 5 cut to 200 nodes and 2,000 pods goes through the serial live
engine (``device="cpu"``, ``pipeline=False``): park, label, requeue,
every pod bound, the store audit passing, and every first-drain bind
equal to ``fullchain.schedule_repair_waves`` on the store's pods in the
engine's pop order — the check phase 17 makes at full width.  The gang cluster cut
to 128 nodes and 41 gangs lands every gang whole.  Exact comparisons;
every wait has a deadline.
"""

from __future__ import annotations

import pytest

from minisched_tpu_torch import live
from minisched_tpu_torch.audit import one_slice_share
from minisched_tpu_torch.fullchain import schedule_repair_waves


def test_config5_live_matches_the_wave_driver_and_audits():
    run = live.run_config5_live(200, 2_000, max_wave=512, device="cpu",
                                timeout_s=120.0, pipeline=False)
    assert run.loop_errors == 0 and run.assumed_left == 0
    assert live.audit_store(run.client, run.labelled) == {"bound": 2_000,
                                                          "nodes": 200}
    assert run.waves >= 5 and len(run.labelled) == 40
    ref = schedule_repair_waves(run.nodes, run.pods, wave=512, device="cpu")
    want = [ref.node_names[c] if c >= 0 else "" for c in ref.choices]
    assert [run.first_drain[p.metadata.name] for p in run.pods] == want
    assert sum(1 for w in want if not w) == 40  # the special pods park
    assert set(run.split) == set(live.SPLIT + live.SPLIT_MORE)
    assert run.split["wave_device"] > 0 and not run.pipelined
    assert run.ttb_p99_le_s is not None



def test_closed_waves_waits_for_the_wave_that_bound_the_last_pod():
    """A wave observes ``wave_size`` as it starts and ``wave`` once its
    binds are done: the count is read only when the two agree."""
    import threading

    from minisched_tpu_torch.observability.profiling import CycleMetrics

    class Engine:
        loop_errors = 0

    metrics = CycleMetrics()
    for _ in range(2):
        metrics.observe("wave_size", 8.0)
    metrics.observe("wave", 0.1)
    closer = threading.Timer(0.2, metrics.observe, ("wave", 0.1))
    closer.start()
    try:
        assert live.closed_waves(metrics, 10.0, Engine()) == 2
    finally:
        closer.cancel()


def test_config5_live_on_a_mesh_counts_every_wave_sharded():
    """Phase 35(b)'s check at a small size: config 5 live under a virtual
    2 x 4 mesh of the host, every pod bound, and ``wave_mesh.waves`` equal
    to the engine's waves, no fallback."""
    import torch

    from minisched_tpu_torch.parallel.sharding import make_mesh

    mesh = make_mesh(8, devices=[torch.device("cpu")] * 8)
    run = live.run_config5_live(200, 2_000, max_wave=512, device="cpu",
                                timeout_s=120.0, pipeline=False, mesh=mesh)
    assert run.loop_errors == 0 and run.assumed_left == 0
    assert live.audit_store(run.client, run.labelled) == {"bound": 2_000,
                                                          "nodes": 200}
    assert run.counters["wave_mesh.waves"] == run.waves >= 5
    assert run.counters["wave_mesh.fallbacks"] == 0


def test_audit_store_catches_a_misplaced_special_pod():
    run = live.run_config5_live(100, 1_000, max_wave=512, device="cpu",
                                timeout_s=120.0)
    special = next(p for p in run.client.pods().list()
                   if p.metadata.name.startswith("special"))
    assert special.spec.node_name in run.labelled
    live.audit_store(run.client, run.labelled)
    with pytest.raises(AssertionError, match="special pods"):
        live.audit_store(run.client, [n for n in run.labelled
                                      if n != special.spec.node_name])


def test_gang_live_lands_every_gang_whole():
    run = live.run_gang_live(128, 1_000, 41, max_wave=512, device="cpu",
                             timeout_s=120.0)
    assert run.loop_errors == 0 and run.assumed_left == 0
    assert run.pending_gangs == {}
    assert live.audit_gangs(run.client) == {"gangs": 41}
    share = one_slice_share(run.nodes, run.assigned, run.pods,
                            live.store_choices(run.client, run.nodes,
                                               run.pods))
    assert share["complete"] == 41


def test_mixed_recorded_run_records_waves_and_exact_scan():
    """``chip_smoke.py`` phase 24's runner on the CPU at a small size:
    the mixed cluster through the serial engine with ``record_results``;
    every bound pod carries a record exactly when a wave or an exact-scan
    chunk recorded it, the others were placed by the blocked lane, and the
    same run without the record places alike."""
    run = live.run_mixed_recorded(64, 96, max_wave=32, device="cpu",
                                  timeout_s=120.0)
    assert run.loop_errors == 0 and run.record_errors == 0
    counts = live.audit_records(run)
    assert counts["with_record"] > 0 and counts["without_record"] > 0
    assert run.scan_stats["blocked"].placed == counts["without_record"]
    assert run.record_calls >= run.waves > 0
    assert run.annotation_bytes > 0 and run.record_ingest_s > 0
    off = live.run_mixed_recorded(64, 96, max_wave=32, device="cpu",
                                  record=False, timeout_s=120.0)
    assert off.placements == run.placements
    assert off.record_calls == 0 and off.annotation_bytes == 0
    assert all(ann == (None, None, None) for ann in off.annotations.values())


def test_config5_over_http_into_the_process():
    """Phase 25(a)'s runner on the CPU at a small size:
    ``__main__.start`` fed config 5 over HTTP, every plain pod seen bound
    over the watch, the HTTP list audited, ``/metrics`` counting every
    bind, and no non-daemon thread left after ``stop``; then phase 27's
    trace probe: 32 more pods, whose whole span chains ``GET
    /debug/trace`` returns within the ring's cap."""
    from minisched_tpu_torch.observability import trace

    run = live.run_config5_http(200, 2_000, device="cpu", chunk=500,
                                timeout_s=120.0, trace_pods=32)
    assert run.bound == run.n_plain == 1_960
    assert run.audit == {"bound": 1_960, "nodes": 200}
    assert run.loop_errors == 0 and run.threads_left == []
    types, samples = run.metrics
    assert types["sched_time_to_bind_seconds"] == "histogram"
    assert sum(v for n, _l, v in samples
               if n == "sched_time_to_bind_seconds_count") == 1_960
    assert run.handler_s["POST pod"] > 0 and run.waves > 0
    assert run.create_s <= run.bind_s
    assert len(run.trace_pods) == 32
    assert 0 < len(run.trace) <= trace._default_cap()
    assert live.audit_trace(run.trace, run.trace_pods)["pods"] == 32
