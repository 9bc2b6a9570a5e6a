"""The port's standalone process, on the CPU: ``ProcessConfig.from_env``
against JAX's, ``__main__.start`` driven through the README scenario over
HTTP, a child ``python -m minisched_tpu_torch`` on the host-only scalar
engine (the scenario, ``metrics <url>``, SIGTERM and exit 0), device mode
refusing to boot without a card, ``start`` over the durable store and
the ``fsck`` subcommand, and what is not ported refusing to start.  Every wait has a deadline; every child is killed in a
``finally``."""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from minisched_tpu.service import config as jconfig

from minisched_tpu_torch import __main__ as tmain
from minisched_tpu_torch.controlplane.httpserver import HTTPClient
from minisched_tpu_torch.live import free_port
from minisched_tpu_torch.observability import counters
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


def test_start_device_mode_on_a_one_device_mesh():
    """``MINISCHED_MESH_DEVICES=1`` (``start(mesh_devices=1)``): the
    device engine over a 1 x 1 mesh of the engine's device (the host
    here, one card on the card machine) places the README scenario as
    the mesh-off engine does, through the mesh ladder."""
    cfg = tconfig.ProcessConfig(port=free_port(), frontend_url="http://x")
    counters.reset()
    client, base, stop = tmain.start(cfg, device_mode=True, device="cpu",
                                     mesh_devices=1)
    try:
        sched = stop.service.scheduler
        assert sched.mesh is not None and sched.mesh.shape == {
            "pods": 1, "nodes": 1}
        assert readme_scenario_http(HTTPClient(base),
                                    log=lambda m: None) == "node10"
        assert counters.get("wave_mesh.waves") >= 1
        assert counters.get("wave_mesh.fallbacks") == 0
    finally:
        stop()


@pytest.mark.parametrize("kw, match", [
    pytest.param({"mesh_devices": 8}, "requested 8 devices, only 1",
                 id="kw0-more mesh devices than visible"),
    pytest.param({"mesh_devices": 2, "device_mode": False},
                 "needs the device engine", id="kw1-mesh without device mode"),
    pytest.param({"external_store_url": "etcd://host:2379"},
                 "unsupported store url", id="kw2-unsupported store url"),
])
def test_start_refuses_what_is_not_ported(kw, match):
    store_url = kw.pop("external_store_url", "")
    cfg = tconfig.ProcessConfig(port=free_port(), frontend_url="x",
                                external_store_url=store_url)
    before = set(threading.enumerate())
    with pytest.raises(ValueError, match=match):
        tmain.start(cfg, device="cpu", **kw)
    assert set(threading.enumerate()) - before == set()  # nothing booted


def test_process_entry_boots_stack_with_store_url(tmp_path):
    """``start`` with ``file://`` (JAX ``tests/test_durable.py``'s test of
    the same name): the durable store beneath the façade, the PV
    controller and the engine (the CPU twins); the bind survives
    ``stop()``, which closes the store, and a reopen."""
    import json
    import urllib.request

    from minisched_tpu_torch.api.objects import make_node, make_pod
    from minisched_tpu_torch.controlplane.durable import DurableObjectStore

    wal = tmp_path / "cluster.wal"
    cfg = tconfig.ProcessConfig(port=free_port(), frontend_url="http://x",
                                external_store_url=f"file://{wal}")
    client, base, stop = tmain.start(cfg, device_mode=True, device="cpu")
    try:
        assert isinstance(stop.store, DurableObjectStore)
        client.nodes().create(make_node("node0"))
        client.pods().create(make_pod("pod1"))
        with urllib.request.urlopen(base + "/api/v1/nodes", timeout=5) as r:
            names = [o["metadata"]["name"] for o in json.load(r)["items"]]
        assert names == ["node0"]
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if client.pods().get("pod1").spec.node_name:
                break
            time.sleep(0.05)
        assert client.pods().get("pod1").spec.node_name == "node0"
    finally:
        stop()
    with pytest.raises(RuntimeError, match="closed"):
        stop.store.create("Node", make_node("late"))
    reopened = DurableObjectStore(str(wal))
    assert reopened.get("Pod", "default", "pod1").spec.node_name == "node0"
    reopened.close()


def test_fsck_cli_clean_and_flipped_bit(tmp_path, capsys):
    """``main(["fsck", wal])`` runs the integrity check without booting the
    scheduler: exit 0 on a clean WAL, 1 once a bit flipped mid-file, as
    JAX's ``python -m minisched_tpu fsck`` answers the same file."""
    import json

    from minisched_tpu.controlplane import fsck as jfsck

    from minisched_tpu_torch.api.objects import make_node, make_pod
    from minisched_tpu_torch.controlplane.durable import DurableObjectStore

    wal = str(tmp_path / "f.wal")
    store = DurableObjectStore(wal)
    store.create("Node", make_node("n0"))
    for i in range(6):
        store.create("Pod", make_pod(f"p{i}"))
    store.close()
    assert tmain.main(["fsck", wal]) == 0
    assert json.loads(capsys.readouterr().out)["ok"] is True
    data = bytearray(open(wal, "rb").read())
    data[len(data) // 2] ^= 0x04
    open(wal, "wb").write(bytes(data))
    assert tmain.main(["fsck", wal]) == 1
    report = json.loads(capsys.readouterr().out)
    assert not report["ok"] and report["errors"]
    assert jfsck.main([wal]) == 1
    assert json.loads(capsys.readouterr().out) == report


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


# -- the client's rate limiter (JAX ``client.py``, ``tests/test_durable.py``)


def test_client_rate_limiter_paces_requests():
    from minisched_tpu_torch.api.objects import make_node
    from minisched_tpu_torch.controlplane.client import Client

    client = Client(qps=50, burst=1)
    client.nodes().create(make_node("n1"))  # consumes the burst token
    t0 = time.monotonic()
    for _ in range(5):
        client.nodes().get("n1")
    # 5 requests at 50 qps take at least ~0.1 s; unlimited, microseconds
    assert time.monotonic() - t0 >= 0.08


def test_client_rate_limiter_burst_is_immediate():
    from minisched_tpu_torch.api.objects import make_node
    from minisched_tpu_torch.controlplane.client import Client

    client = Client(qps=1, burst=10)
    t0 = time.monotonic()
    client.nodes().create(make_node("n1"))
    for _ in range(8):
        client.nodes().get("n1")
    assert time.monotonic() - t0 < 0.5


def test_limiter_surface_equal_to_jax():
    """The reference's limits, the throttled set, the default client
    unthrottled, and ``TokenBucket``'s refusals and clamp, as JAX's."""
    from minisched_tpu.controlplane import client as jclient

    from minisched_tpu_torch.controlplane import client as tclient

    assert (tclient.DEFAULT_QPS, tclient.DEFAULT_BURST) == (
        jclient.DEFAULT_QPS, jclient.DEFAULT_BURST) == (5000.0, 5000)
    assert tclient._ThrottledStore._THROTTLED == \
        jclient._ThrottledStore._THROTTLED
    assert tclient.Client().rate_limiter is None
    assert jclient.Client().rate_limiter is None
    for mod in (tclient, jclient):
        with pytest.raises(ValueError):
            mod.TokenBucket(0, 1)
        bucket = mod.TokenBucket(1000.0, 0)  # clamped to one token
        assert bucket._burst == 1.0
        c = mod.Client(qps=100.0)
        assert c.rate_limiter._burst == 100.0  # burst defaults to qps


@pytest.mark.parametrize("side", ["jax", "port"])
def test_throttled_store_takes_one_token_per_request(side):
    """Every throttled store call and every ``bind_many`` batch take one
    token; a watch takes one at subscription and none per event; the
    untouched surface (``resource_version``) takes none.  Counted on a
    bucket that records its acquires, on both packages."""
    if side == "jax":
        from minisched_tpu.api.objects import Binding, make_node, make_pod
        from minisched_tpu.controlplane import client as mod
    else:
        from minisched_tpu_torch.api.objects import Binding, make_node, \
            make_pod
        from minisched_tpu_torch.controlplane import client as mod

    client = mod.Client(qps=1e9, burst=10**9)
    taken = []
    real = client.rate_limiter.acquire
    client.rate_limiter.acquire = lambda: (taken.append(1), real())[1]
    client.nodes().create(make_node("n1"))
    client.pods().create_many([make_pod(f"p{i}") for i in range(3)])
    client.pods().get("p0")
    client.pods().list()
    w, _ = client.store.watch("Pod", send_initial=False)
    client.pods().bind_many([Binding("p0", "default", "n1")])
    events = w.next_batch(timeout=1.0)
    w.stop()
    _ = client.store.resource_version
    assert len(events) == 1
    assert len(taken) == 6  # create, create_many, get, list, watch, bind


def test_start_throttles_the_client_and_serves_the_raw_store():
    """``__main__.start`` builds its client with the reference's limits
    (as JAX's ``__main__`` does) and the façade serves the store under
    the limiter, unwrapped: an HTTP request takes no client token."""
    from minisched_tpu_torch.controlplane.client import (
        DEFAULT_BURST,
        DEFAULT_QPS,
        _ThrottledStore,
    )
    from minisched_tpu_torch.controlplane.store import ObjectStore

    cfg = tconfig.ProcessConfig(port=free_port(), frontend_url="http://x")
    client, base, stop = tmain.start(cfg, device_mode=False)
    try:
        assert isinstance(client.store, _ThrottledStore)
        assert client.rate_limiter._qps == DEFAULT_QPS
        assert client.rate_limiter._burst == float(DEFAULT_BURST)
        assert stop.service._client is client
        raw = client.store._store
        assert isinstance(raw, ObjectStore)
        # the recorder's SchedulerStarted event takes its token on the
        # recorder's thread: let it land before counting
        stop.service.recorder.flush()
        taken = []
        real = client.rate_limiter.acquire
        client.rate_limiter.acquire = lambda: (taken.append(1), real())[1]
        http = HTTPClient(base)
        from minisched_tpu_torch.api.objects import make_node

        http.nodes().create(make_node("via-http"))
        assert raw.get("Node", "", "via-http").metadata.name == "via-http"
        assert taken == []
    finally:
        stop()
