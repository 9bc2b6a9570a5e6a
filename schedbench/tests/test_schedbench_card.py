"""On the card: one short traced run of a cell through the command, as
the driver runs it (skips without a card).  The window holds three
rollouts, so one starts past its first third and is traced."""

import json
import subprocess
import sys

import pytest

from .conftest import REPO


@pytest.mark.cuda
def test_short_traced_run_on_the_card(card):
    proc = subprocess.run(
        [sys.executable, "-m", "schedbench", "--workload",
         "k8s-5k.spread-recreate", "--seed", "2147483653", "--seconds", "20",
         "--trace", "1"], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["check"]
    assert list(line)[-1] == "check"
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert 0 < line["metrics"]["select_hosts_roofline"]["value"] <= 100
    assert 0 <= line["metrics"]["device.idle_pct"]["value"] < 100
