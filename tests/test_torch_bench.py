"""The port's bench roles without a card: each prints one skip record and
exits 0, as ``bench.py``'s roles do where the environment cannot run
them; none runs on the CPU instead.  The roles are those of
``bench.py`` the port can run, by the names the module documents."""

from __future__ import annotations

import json
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


def test_percentile_is_nearest_rank_as_bench_py():
    """``_pct`` is ``bench.py``'s nearest rank (ceil(p·n)−1)."""
    samples = sorted(float(i) for i in range(1, 101))
    assert bench._pct(samples, 0.99) == 99.0
    assert bench._pct(samples, 0.50) == 50.0
    assert bench._pct([3.0], 0.99) == 3.0
