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
    "c2": "bench_config2",
    "c3": "bench_config3",
    "c4": "bench_config4",
    "c5": "config5_full_chain",
    "c5_waves": "config5_full_chain",
    "fullchain_parity": "bench_fullchain_parity",
    "c5x": "config5_crosspod",
    "gang": "bench_gang",
    "c5x_live": "BENCH_C5_CROSSPOD",
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
