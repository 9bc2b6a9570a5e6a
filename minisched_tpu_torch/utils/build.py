"""Build the port's CUDA sources into one shared library and load it.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a``, then linked into ``libminisched_kernels.so``
under ``<build dir>/<hash>/``, keyed by a hash of the sources and flags.
The build directory is ``utils/compilecache.py``'s: ``_build/`` unless
``MINISCHED_CACHE_DIR`` or ``MINISCHED_CACHE=0`` says otherwise.  The
library has a plain C interface and is loaded with ``ctypes``; no PyTorch
header is compiled.  The build happens at first use, never at import, and
a failed build raises with nvcc's output — there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
LIB_NAME = "libminisched_kernels.so"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ARCH_FLAGS + ("-shared",)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_dir: Optional[Path] = None


def set_build_dir(path: Path) -> None:
    """Where the next build goes (``compilecache.enable_persistent_cache``
    sets it)."""
    global _build_dir
    _build_dir = Path(path)


def build_dir() -> Path:
    """The build directory in effect: the one set last, else the knobs'
    (``compilecache.default_build_dir``), fixed at the first call."""
    global _build_dir
    if _build_dir is None:
        from minisched_tpu_torch.utils.compilecache import default_build_dir

        _build_dir = default_build_dir()
    return _build_dir


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "kernels cannot be built"
    )


def _sources() -> List[Path]:
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return sources


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256()
    for flag in COMPILE_FLAGS + LINK_FLAGS:
        digest.update(flag.encode() + b"\0")
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return build_dir() / digest.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile and link the library if it is not built yet; its path."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
        log = []
        failed = []
        for src, _obj, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name} (rc {proc.returncode})\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        (out.parent / "nvcc.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(
                f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(log)
            )
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *LINK_FLAGS, *(str(o) for _s, o, _p in procs),
             "-o", str(tmp_lib)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed:\n{link.stdout}{link.stderr}"
            )
        os.replace(tmp_lib, out)  # atomic: a reader sees all or nothing
    return out


def build_log() -> str:
    """nvcc's output (registers, spills) from the build of the current
    sources, or '' before the first build."""
    log = library_path().parent / "nvcc.log"
    return log.read_text() if log.exists() else ""


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib
