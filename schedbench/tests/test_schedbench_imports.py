"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names; the reference side loads nothing of the port."""

import ast
import subprocess
import sys

from schedbench.__main__ import forbidden_modules
from schedbench.spec import PACKAGE_DIR

from .conftest import REPO

#: modules of the yardstick: they may import neither the port nor JAX
REFERENCE_SIDE = ("reference", "check", "cluster", "roofline", "control",
                  "spec")
GENERATORS = sorted((PACKAGE_DIR / "generators").glob("*.py"))


def _imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_forbidden_names_are_compared_whole():
    mods = ["minisched_tpu_torch", "minisched_tpu_torch.ops", "numpy",
            "jaxtyping", "minisched_tpux"]
    assert forbidden_modules(mods) == []
    assert forbidden_modules(mods + ["jax", "jax.numpy", "jaxlib.xla",
                                     "flax", "minisched_tpu.ops"]) == [
        "flax", "jax", "jax.numpy", "jaxlib.xla", "minisched_tpu.ops"]


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in PACKAGE_DIR.rglob("*.py"):
        bad = _imported(path) & {"jax", "jaxlib", "flax", "minisched_tpu"}
        assert not bad, (path, bad)


def test_reference_side_imports_nothing_of_the_port():
    assert GENERATORS
    for path in [PACKAGE_DIR / f"{n}.py" for n in REFERENCE_SIDE] + GENERATORS:
        assert "minisched_tpu_torch" not in _imported(path), path
    code = ("import sys\n"
            + "".join(f"import schedbench.{n}\n" for n in REFERENCE_SIDE)
            + "from schedbench.spec import _load\n"
            + "".join(f"_load(__import__('pathlib').Path({str(p)!r}))\n"
                      for p in GENERATORS)
            + "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(ast.literal_eval(out.strip().splitlines()[-1]))
    assert not loaded & {"minisched_tpu_torch", "minisched_tpu", "jax",
                         "jaxlib", "flax", "torch"}


def test_a_run_loads_no_jax(tmp_path):
    """A whole run (on the CPU) in a fresh process, then the loaded
    modules' top-level names."""
    from .conftest import tiny_bench

    root = tiny_bench(tmp_path)
    code = (
        "import sys, time\n"
        "from pathlib import Path\n"
        "from schedbench.spec import find_cell\n"
        "from schedbench.harness import Run\n"
        "from schedbench.__main__ import forbidden_modules\n"
        f"root = Path({str(root)!r})\n"
        "cell = find_cell(root, 'tiny.small', package_dir=root / "
        "'schedbench')\n"
        "Run(cell, 3, 1.0, False, 'cpu', time.monotonic()).run()\n"
        "print(forbidden_modules(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    assert out.strip().splitlines()[-1] == "[]"


def test_without_a_card_the_command_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "schedbench", "--workload",
         "k8s-5k.spread-recreate", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(REPO)}, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
