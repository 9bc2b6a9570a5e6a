"""Cells, configurations, mixes and metrics are found by name from data."""

import json

from schedbench.spec import (
    PACKAGE_DIR,
    find_cell,
    generator,
    load_benchmark,
    reports,
)

from .conftest import REPO, cpu_run, tiny_bench


def test_every_listed_cell_is_found_with_its_files():
    bench = load_benchmark(REPO)
    assert bench["workloads"]
    for w in bench["workloads"]:
        cell = find_cell(REPO, w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        want = {m["name"] for m in bench["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])}
        assert {m["name"] for m in cell.end_to_end} == want
        assert {"pods_per_s", "setup_s"} <= want
        for m in cell.per_layer:
            assert (PACKAGE_DIR / "metrics" / f"{m['name']}.py").exists()


def test_config_files_hold_the_benchmark_entries():
    bench = load_benchmark(REPO)
    for c in bench["configs"]:
        data = json.loads((REPO / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]


def test_metric_without_workloads_key_follows_what_it_moves():
    m = {"name": "x", "moves": "pods_per_s"}
    assert reports(m, "a.b", ["pods_per_s", "setup_s"])
    assert not reports(m, "a.b", ["setup_s"])
    assert not reports(dict(m, workloads=["c.d"]), "a.b", ["pods_per_s"])


def test_a_cell_and_a_metric_are_added_by_files_and_entries_alone(tmp_path):
    """A new configuration, mix (with a generator of its own), cell and
    per-layer metric in a copy: only new files and new entries, and a run
    reports the new metric."""
    root = tiny_bench(tmp_path)
    pkg = root / "schedbench"
    config = json.loads((pkg / "configs" / "tiny.json").read_text())
    config.update(name="tiny2", nodes=40)
    (pkg / "configs" / "tiny2.json").write_text(json.dumps(config))
    traffic = json.loads((pkg / "traffic" / "small.json").read_text())
    traffic.update(name="smaller", replicas=16, generator="scaleup")
    traffic["pod"]["labels"] = {"foo": "baz"}
    for c in traffic["pod"]["spread"]:
        c["match_labels"] = {"foo": "baz"}
    (pkg / "traffic" / "smaller.json").write_text(json.dumps(traffic))
    # a mix that only scales up: the recreate generator, deleting nothing
    (pkg / "generators" / "scaleup.py").write_text(
        "from schedbench.spec import _load, PACKAGE_DIR\n"
        "base = _load(PACKAGE_DIR / 'generators' / 'recreate.py')\n"
        "class ScaleUp(base.Recreate):\n"
        "    def _next(self):\n"
        "        self._live = []\n"
        "        return super()._next()\n"
        "def make(traffic, seed):\n"
        "    return ScaleUp(traffic, seed)\n")
    (pkg / "metrics" / "scan.calls_per_pod.py").write_text(
        "def read(ctx):\n"
        "    u = ctx.untraced\n"
        "    placed = sum(l['placed'] for l in u.lanes.values())\n"
        "    calls = sum(l['calls'] for l in u.lanes.values())\n"
        "    return calls / placed if placed else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="tiny2",
                                 file="schedbench/configs/tiny2.json"))
    bench["workloads"].append({"name": "tiny2.smaller", "config": "tiny2",
                               "traffic": "smaller", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({
        "name": "scan.calls_per_pod", "unit": "calls", "better": "lower",
        "source": "program_counter", "layer": "engine scan lanes",
        "moves": "pods_per_s", "workloads": ["tiny2.smaller"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = find_cell(root, "tiny2.smaller", package_dir=pkg)
    assert cell.config["nodes"] == 40 and cell.traffic["replicas"] == 16
    assert type(generator(cell, 1)).__name__ == "ScaleUp"
    assert [m["name"] for m in cell.per_layer] == ["scan.calls_per_pod"]
    _run, counts, line = cpu_run(root, "tiny2.smaller", trace=True)
    assert line["correct"], counts
    assert line["metrics"]["scan.calls_per_pod"]["value"] > 0
