"""The port's standalone process, on the CPU: ``ProcessConfig.from_env``
against JAX's, ``__main__.start`` driven through the README scenario over
HTTP, a child ``python -m minisched_tpu_torch`` on the host-only scalar
engine (the scenario, ``metrics <url>``, SIGTERM and exit 0), device mode
refusing to boot without a card, and what is not ported refusing to
start.  Every wait has a deadline; every child is killed in a
``finally``."""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from minisched_tpu.service import config as jconfig

from minisched_tpu_torch import __main__ as tmain
from minisched_tpu_torch.controlplane.httpserver import HTTPClient
from minisched_tpu_torch.live import free_port
from minisched_tpu_torch.scenario.runner import readme_scenario_http
from minisched_tpu_torch.service import config as tconfig

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("env", [
    {"PORT": "10251", "FRONTEND_URL": "http://localhost:3000"},
    {"PORT": "1", "FRONTEND_URL": "x",
     "MINISCHED_TPU_STORE_URL": "file:///tmp/c.wal"},
    {"PORT": "", "FRONTEND_URL": "x"},
    {"FRONTEND_URL": "x"},
    {"PORT": "10251"},
    {"PORT": "10251", "FRONTEND_URL": ""},
])
def test_process_config_from_env_as_jax(env):
    def load(config):
        try:
            cfg = config.ProcessConfig.from_env(env)
            return (cfg.port, cfg.frontend_url, cfg.external_store_url)
        except config.EmptyEnvError as e:
            return ("EmptyEnvError", str(e))

    assert load(tconfig) == load(jconfig)
    with pytest.raises(ValueError):
        tconfig.ProcessConfig.from_env({"PORT": "ten", "FRONTEND_URL": "x"})


def test_start_device_mode_readme_over_http_and_stop():
    """``start`` on the device engine (the CPU twins here), the README
    scenario through the façade, then ``stop``: no non-daemon thread of
    the stack is left."""
    before = set(threading.enumerate())
    cfg = tconfig.ProcessConfig(port=free_port(), frontend_url="http://x")
    client, base, stop = tmain.start(cfg, device_mode=True, device="cpu")
    try:
        assert base.endswith(f":{cfg.port}")
        http = HTTPClient(base)
        assert readme_scenario_http(http, log=lambda m: None) == "node10"
        assert client.pods().get("pod1").spec.node_name == "node10"
    finally:
        stop()
    left = [t for t in set(threading.enumerate()) - before
            if t.is_alive() and not t.daemon]
    assert left == []


@pytest.mark.parametrize("kw, match", [
    ({"mesh_devices": 8}, "ROADMAP item 12"),
    ({"external_store_url": "file:///tmp/x.wal"}, "durable store"),
    ({"external_store_url": "etcd://host:2379"}, "unsupported store url"),
])
def test_start_refuses_what_is_not_ported(kw, match):
    store_url = kw.pop("external_store_url", "")
    cfg = tconfig.ProcessConfig(port=free_port(), frontend_url="x",
                                external_store_url=store_url)
    before = set(threading.enumerate())
    with pytest.raises(ValueError, match=match):
        tmain.start(cfg, device="cpu", **kw)
    assert set(threading.enumerate()) - before == set()  # nothing booted


def test_fsck_refused():
    with pytest.raises(ValueError, match="durable store"):
        tmain.main(["fsck", "/tmp/x.wal"])


def _child(port: int, **env):
    full = dict(os.environ, PORT=str(port), FRONTEND_URL="http://x",
                PYTHONPATH=str(ROOT), **env)
    return subprocess.Popen(
        [sys.executable, "-m", "minisched_tpu_torch"], cwd=ROOT, env=full,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _api_line(proc, timeout=60.0) -> str:
    """The child's "API on" line (read on a thread: readline blocks)."""
    out = []
    t = threading.Thread(target=lambda: out.append(proc.stdout.readline()),
                         daemon=True)
    t.start()
    t.join(timeout)
    assert out and "API on" in out[0], (out, proc.poll())
    return out[0]


def test_child_process_scalar_engine_readme_metrics_sigterm():
    port = free_port()
    proc = _child(port, MINISCHED_DEVICE_MODE="0")
    try:
        line = _api_line(proc)
        base = f"http://127.0.0.1:{port}"
        assert base in line
        http = HTTPClient(base)
        assert readme_scenario_http(http, log=lambda m: None) == "node10"
        scrape = subprocess.run(
            [sys.executable, "-m", "minisched_tpu_torch", "metrics", base],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
            capture_output=True, text=True, timeout=60)
        assert scrape.returncode == 0, scrape.stderr
        assert "histogram sched_time_to_bind_seconds: count=1" in (
            scrape.stdout)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_child_process_device_mode_needs_a_card():
    """The default engine is the device engine on the card: without one
    the process exits non-zero at boot (no fallback to the CPU); with
    one it serves."""
    port = free_port()
    proc = _child(port)
    try:
        if torch.cuda.is_available():
            _api_line(proc)
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=30) == 0
        else:
            out, _ = proc.communicate(timeout=60)
            assert proc.returncode != 0
            assert "no CUDA device" in out and "API on" not in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_metrics_cli_usage_and_unreachable():
    assert tmain.main(["metrics"]) == 2
    assert tmain.main(["metrics", f"http://127.0.0.1:{free_port()}"]) == 1
