"""Shared pieces of the benchmark's tests.  Run them from the checkout's
root: ``python -m pytest schedbench/tests -q`` (the card's tests, marked
``cuda``, skip without a card: ``-m cuda`` on the card's machine)."""

import json
import shutil
import time
from pathlib import Path

import pytest

from schedbench.spec import PACKAGE_DIR, find_cell

REPO = PACKAGE_DIR.parent


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one; run with "
        "-m cuda)")


@pytest.fixture
def card():
    """The card, or a skip when there is none (decided here, not at
    import or collection)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


def tiny_bench(root: Path, replicas: int = 24, nodes: int = 48,
               initial: int = 48, zone_skew: int = 1, drain_s: float = 20
               ) -> Path:
    """A copy of the benchmark under ``root`` with one small cell,
    ``tiny.small``: ``c5-10k``'s shapes on ``nodes`` nodes, one controller
    recreating a spread Deployment of ``replicas`` pods whose zone
    constraint has the skew ``zone_skew`` (tight, so that a few pods
    meet it)."""
    pkg = root / "schedbench"
    (pkg / "configs").mkdir(parents=True)
    (pkg / "traffic").mkdir()
    shutil.copytree(PACKAGE_DIR / "metrics", pkg / "metrics")
    shutil.copytree(PACKAGE_DIR / "generators", pkg / "generators")
    config = json.loads((PACKAGE_DIR / "configs" / "c5-10k.json")
                        .read_text())
    config.update(name="tiny", nodes=nodes)
    config["initial_pods"]["count"] = initial
    (pkg / "configs" / "tiny.json").write_text(json.dumps(config))
    traffic = json.loads((PACKAGE_DIR / "traffic" / "spread-recreate.json")
                         .read_text())
    traffic.update(name="small", replicas=replicas, drain_s=drain_s)
    for c in traffic["pod"]["spread"]:
        if c["topology_key"] == "topology.kubernetes.io/zone":
            c["max_skew"] = zone_skew
    (pkg / "traffic" / "small.json").write_text(json.dumps(traffic))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [dict(bench["configs"][0], name="tiny",
                             file="schedbench/configs/tiny.json")]
    bench["workloads"] = [{"name": "tiny.small", "config": "tiny",
                           "traffic": "small", "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny.small"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def cpu_run(root: Path, workload: str = "tiny.small", seed: int = 7,
            seconds: float = 2.0, trace: bool = False):
    """One run of a cell of the copy at ``root`` on the CPU (the
    kernels' plain twins): (the run, its counts, its result line)."""
    from schedbench.harness import Run, check_counts, result_line

    cell = find_cell(root, workload, package_dir=root / "schedbench")
    run = Run(cell, seed, seconds, trace, "cpu", time.monotonic())
    run.run()
    counts = check_counts(run)
    return run, counts, result_line(run, counts, {"platform": "cpu"})
