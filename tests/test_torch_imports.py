"""The port stands alone: no JAX, nothing of the JAX package.

Every module of ``minisched_tpu_torch``, ``chip_smoke.py`` and the card
tests (``tests/test_torch_cuda.py``) is parsed
with ``ast``; an import of ``jax`` (or ``jaxlib``) or of ``minisched_tpu``
fails the test.  A fresh interpreter then imports the whole port and
checks that neither was loaded on the way.
"""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "minisched_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "minisched_tpu")


def _sources():
    # the card tests run where JAX is not installed, and the processes
    # the tests spawn import their targets' module
    return sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py",
        ROOT / "tests" / "process_mesh_child.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_mesh_across_processes_is_checked():
    """The group, the spawn and the ranks' steps are among the sources
    parsed above, and so is the spawned children's test module."""
    names = {p.relative_to(ROOT).as_posix() for p in _sources()}
    assert {"minisched_tpu_torch/parallel/distributed.py",
            "minisched_tpu_torch/parallel/rank_steps.py",
            "tests/process_mesh_child.py"} <= names


def test_forbidden_matches_only_the_jax_side():
    assert _forbidden("jax.numpy") and _forbidden("minisched_tpu.ops.fused")
    assert not _forbidden("minisched_tpu_torch.ops.fused")
    assert not _forbidden("jaxtyping")


def test_importing_the_port_loads_no_jax():
    modules = [
        "minisched_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in sorted(PORT.rglob("*.py")) if p.name != "__init__.py"
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'minisched_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
