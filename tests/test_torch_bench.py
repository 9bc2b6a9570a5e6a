"""The port's bench roles without a card: each prints one skip record and
exits 0, as ``bench.py``'s roles do where the environment cannot run
them; none runs on the CPU instead.  The roles are those of
``bench.py`` the port can run, by the names the module documents."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from minisched_tpu_torch import bench

ROOT = Path(__file__).resolve().parent.parent

#: role → the ``bench.py`` role it ports (``bench.py``'s own names)
COUNTERPARTS = {
    "headline": "bench_headline",
    "c1": "bench_config1",
    "c2": "bench_config2",
    "c3": "bench_config3",
    "c4": "bench_config4",
    "c5": "config5_full_chain",
    "c5_waves": "config5_full_chain",
    "fullchain_parity": "bench_fullchain_parity",
    "c5x": "config5_crosspod",
    "gang_waves": "config5_full_chain",
    "c5x_live": "BENCH_C5_CROSSPOD",
    "wave": "bench_wave_pipeline",
    "gang": "bench_gang",
    "churn": "bench_churn",
    "wire": "bench_wire",
    "wire_fanout": "bench_wire_fanout",
    "relist": "bench_relist",
    "wal": "bench_wal",
    "repl": "bench_repl",
    "readscale": "bench_readscale",
    "shard": "bench_shard",
    "chaos": "bench_chaos",
    "disk": "bench_disk",
    "ha": "bench_ha",
    "mesh": "bench_mesh",
}

#: small sizes of the fault and HA roles for a run on the CPU (their
#: ``bench.py`` knobs; every other default and gate as the role has it)
SMALL = {
    "chaos": {"BENCH_CHAOS_NODES": "16", "BENCH_CHAOS_PODS": "160",
              "BENCH_CHAOS_WAVE": "32"},
    "disk": {"BENCH_DISK_NODES": "8", "BENCH_DISK_PODS": "200",
             "BENCH_DISK_WAVE": "32"},
    "ha": {"BENCH_HA_NODES": "8", "BENCH_HA_PODS": "120"},
}


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(bench.torch.cuda, "is_available", lambda: False)


def test_roles_are_the_portable_bench_roles():
    assert bench.ROLES == tuple(COUNTERPARTS)
    text = (ROOT / "bench.py").read_text()
    for name in COUNTERPARTS.values():
        assert name in text, name
    for role in bench.ROLES:
        assert callable(getattr(bench, f"role_{role}"))
        assert f"``{role}``" in bench.__doc__


@pytest.mark.parametrize("role", list(COUNTERPARTS))
def test_role_prints_one_skip_record_without_a_card(role, no_card, capsys):
    assert bench.main(["--only", role]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    record = json.loads(lines[0])
    assert record == {"role": role, "skipped": "no CUDA device is available"}


def test_every_role_by_default(no_card, capsys):
    assert bench.main([]) == 0
    records = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["role"] for r in records] == list(bench.ROLES)
    assert all("skipped" in r for r in records)


def test_module_entry_point_exits_zero():
    """``python3 -m minisched_tpu_torch.bench --only c2`` in a fresh
    interpreter (no card here): one skip record, exit 0."""
    if bench.torch.cuda.is_available():
        pytest.skip("a card is present: the role would run")
    proc = subprocess.run(
        [sys.executable, "-m", "minisched_tpu_torch.bench", "--only", "c2"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == {"role": "c2",
                                       "skipped": "no CUDA device is available"}


def test_wave_role_skips_with_the_pipeline_off(monkeypatch):
    """``MINISCHED_PIPELINE=0`` skips the ``wave`` role before it builds
    anything, with ``bench.py``'s reason; with a card the record is
    ``{"role": "wave", "skipped": ...}``."""
    monkeypatch.setenv("MINISCHED_PIPELINE", "0")
    with pytest.raises(bench.Skip, match="MINISCHED_PIPELINE=0"):
        bench.role_wave()
    monkeypatch.setattr(bench.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench, "card_line", lambda: "card, 700.00 W")
    from minisched_tpu_torch.utils import build

    monkeypatch.setattr(build, "load_library", lambda: None)
    assert bench.run_role("wave") == {
        "role": "wave",
        "skipped": "MINISCHED_PIPELINE=0: pipeline disabled by env"}


@pytest.mark.parametrize("role", list(SMALL))
def test_fault_and_ha_roles_at_a_small_size_on_the_cpu(role, monkeypatch):
    """``role_chaos``, ``role_disk`` and ``role_ha`` with ``device="cpu"``
    at a small size: each meets its ``bench.py`` gates (it raises
    otherwise) and keeps ``bench.py``'s record keys."""
    for k, v in SMALL[role].items():
        monkeypatch.setenv(k, v)
    rec = getattr(bench, f"role_{role}")(device="cpu")
    assert rec["loop_errors"] == 0
    assert rec["double_bind"] is False
    if role == "chaos":
        assert rec["pods"] == 160 and rec["leak"] is False
        assert rec["injected"].get("store.update", 0) >= 1
        assert set(rec["injected"]) <= set(rec["draws"])
    elif role == "disk":
        assert rec["injected"].get("disk.enospc", 0) >= 1
        assert rec["bitflips_detected"] >= rec["injected"].get(
            "wal.bitflip", 0)
    else:
        assert rec["engines"] == 3 and rec["kills"] == 1
        assert rec["rebalance_s"] <= 2.0 + 2.0 / 3.0 + 1.5
        assert rec["counters"].get("ha.member_lost", 0) >= 2



@pytest.mark.parametrize("argv", [["--only", "mesh"], []],
                         ids=["only-mesh", "every-role"])
def test_entry_point_finds_every_role(argv):
    """``python -m minisched_tpu_torch.bench`` with no card: every role
    asked for is found in the module as it runs as ``__main__`` (each is
    looked up before the card check) and prints its skip record; exit
    0."""
    env = {k: v for k, v in os.environ.items()}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, "-m", "minisched_tpu_torch.bench", *argv],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    records = [json.loads(line) for line in out.stdout.splitlines()]
    want = argv[1:] or list(bench.ROLES)
    assert [r["role"] for r in records] == want
    assert all(r["skipped"] == "no CUDA device is available"
               for r in records)


def test_mesh_role_skips_on_a_one_card_host(monkeypatch):
    """As ``bench_mesh`` below two devices: the role skips with its
    reason before it builds anything (one card here, as on the card
    machine); ``run_role`` prints the skip record."""
    monkeypatch.setattr(bench.torch.cuda, "device_count", lambda: 1)
    with pytest.raises(bench.Skip, match="more than one device"):
        bench.role_mesh()
    monkeypatch.setattr(bench.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench, "card_line", lambda: "card, 700.00 W")
    from minisched_tpu_torch.utils import build

    monkeypatch.setattr(build, "load_library", lambda: None)
    record = bench.run_role("mesh")
    assert record["role"] == "mesh"
    assert "more than one device" in record["skipped"]


def test_mesh_role_core_on_a_virtual_cpu_mesh(monkeypatch):
    """The role's parity and audit core at a small size on a virtual
    2 x 4 mesh of the host: the sharded lap places every pod as the
    single-device lap, with sharded waves and no fallback; the
    device-time gate is not armed over one device."""
    import torch

    from minisched_tpu_torch.parallel.sharding import make_mesh

    monkeypatch.setenv("BENCH_MESH_NODES", "40")
    monkeypatch.setenv("BENCH_MESH_PODS", "300")
    monkeypatch.setenv("BENCH_MESH_WAVE", "128")
    mesh = make_mesh(8, devices=[torch.device("cpu")] * 8)
    rec = bench.role_mesh(device="cpu", mesh=mesh)
    assert rec["parity_ok"] and rec["mesh_shape"] == [["pods", 2],
                                                      ["nodes", 4]]
    assert rec["sharded"]["wave_mesh"]["waves"] >= 1
    assert rec["sharded"]["wave_mesh"]["fallbacks"] == 0
    assert rec["single_device"]["wave_mesh"]["waves"] == 0
    assert rec["device_gate"].startswith("not armed")
    assert rec["distinct_devices"] == 1


def test_percentile_is_nearest_rank_as_bench_py():
    """``_pct`` is ``bench.py``'s nearest rank (ceil(p·n)−1)."""
    samples = sorted(float(i) for i in range(1, 101))
    assert bench._pct(samples, 0.99) == 99.0
    assert bench._pct(samples, 0.50) == 50.0
    assert bench._pct([3.0], 0.99) == 3.0
