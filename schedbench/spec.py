"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout lists the cells
(``workloads``), each naming a configuration and a traffic mix, and the
metrics.  Everything that belongs to one configuration, one mix or one
per-layer metric sits in a file of its own under this package, found by
its name alone:

* ``configs/<config>.json``: the deployment (nodes, their labels, the
  pods running at set-up, the guarantees);
* ``traffic/<traffic>.json``: the parameters of the mix, with the pods'
  templates, read by the generator it names (``generators/<generator>.py``,
  whose ``make(traffic, seed)`` gives the clients' state: see
  ``generators/recreate.py``);
* ``metrics/<metric name>.py``: a reader with ``read(ctx)`` returning a
  number, or None when it finds nothing to read.

A later cell, mix, configuration or per-layer metric is added by adding
files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

#: the directory of this package; the checkout's root is its parent
PACKAGE_DIR = Path(__file__).resolve().parent


@dataclass
class Cell:
    """One entry of ``workloads`` with its parts loaded."""

    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    #: the end-to-end metrics this cell reports (entries of ``end_to_end``)
    end_to_end: List[Dict[str, Any]]
    #: the per-layer metrics this cell reports (entries of ``per_layer``)
    per_layer: List[Dict[str, Any]]
    #: where the cell's files were found (its metric readers too)
    package_dir: Path = PACKAGE_DIR


def load_benchmark(root: Path) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json", encoding="utf-8") as f:
        return json.load(f)


def _load_json(path: Path) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def reports(metric: Dict[str, Any], cell: str,
            cell_e2e: List[str]) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    key lists, or, without the key, every cell that reports the
    end-to-end metric it moves (per-layer) or every cell (end-to-end)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or moves in cell_e2e


def find_cell(root: Path, workload: str,
              package_dir: Path = PACKAGE_DIR) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its
    configuration, traffic and metric entries.  Raises KeyError for a
    name the file does not list."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have: {', '.join(sorted(cells))})")
    w = cells[workload]
    config = _load_json(package_dir / "configs" / f"{w['config']}.json")
    traffic = _load_json(package_dir / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if reports(m, workload, [])]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"]
                 if reports(m, workload, e2e_names)]
    return Cell(w["name"], int(w.get("chips", 1)), config, traffic, e2e,
                per_layer, package_dir)


def _load(path: Path) -> Any:
    """The module at ``path``, loaded by path (metric names hold dots,
    which module names may not)."""
    spec = importlib.util.spec_from_file_location(
        f"schedbench_file_{abs(hash(str(path)))}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, package_dir: Path = PACKAGE_DIR
                  ) -> Callable[[Any], Optional[float]]:
    """``metrics/<name>.py``'s ``read``."""
    return _load(package_dir / "metrics" / f"{name}.py").read


def generator(cell: Cell, seed: int) -> Any:
    """The state of ``cell``'s clients, from the generator its mix names."""
    name = cell.traffic["generator"]
    return _load(cell.package_dir / "generators" / f"{name}.py").make(
        cell.traffic, seed)
