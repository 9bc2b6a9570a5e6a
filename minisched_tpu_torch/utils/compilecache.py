"""Where the port's CUDA kernels are built and cached.

Counterpart of ``minisched_tpu/utils/compilecache.py`` (JAX ``:58-88``).
JAX caches jitted executables on disk; the port's build artefact is the
kernels' shared library (``utils/build.py``: one ``nvcc`` per source,
linked into ``libminisched_kernels.so`` under ``<dir>/<hash>/``, keyed by
a hash of the sources and flags).  The knobs are JAX's:

* ``MINISCHED_CACHE=0`` disables the persistent cache: the library is
  built into a temporary directory that is removed at exit, so every
  process builds afresh;
* ``MINISCHED_CACHE_DIR`` relocates it: the build lands under
  ``<dir>/<_machine_key()>/<hash>/`` (the host's machine type namespaces
  it, as in JAX: the library's host half is compiled for this CPU);
* neither: ``minisched_tpu_torch/_build/<hash>/`` (gitignored), where the
  port has always built.

Call :func:`enable_persistent_cache` before the first kernel launch, as
``python3 -m minisched_tpu_torch`` does in device mode; without a call
the first build resolves the same knobs from the environment.  A library
already loaded in the process stays loaded: the knobs act on the next
process.
"""

from __future__ import annotations

import atexit
import hashlib
import os
import platform
import shutil
import tempfile
from pathlib import Path
from typing import Optional

_DEFAULT_DIR = Path(__file__).resolve().parent.parent / "_build"


def _machine_key() -> str:
    """Fingerprint of the host machine type: arch and CPU flags (JAX's
    ``_machine_key``)."""
    flags = ""
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    flags = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass  # non-Linux: arch alone still separates the big classes
    digest = hashlib.sha1(
        f"{platform.machine()}|{flags}".encode()).hexdigest()[:12]
    return f"{platform.machine()}-{digest}"


def _temporary_dir() -> Path:
    tmp = Path(tempfile.mkdtemp(prefix="minisched-kernels-"))
    atexit.register(shutil.rmtree, tmp, ignore_errors=True)
    return tmp


def resolve_cache_dir(cache_dir: Optional[str] = None,
                      env: Optional[dict] = None) -> Optional[Path]:
    """The build directory the knobs give: None when ``MINISCHED_CACHE=0``
    (the caller builds into a temporary directory), ``<dir>/<machine>``
    for ``cache_dir`` or ``MINISCHED_CACHE_DIR``, else ``_build``."""
    env = os.environ if env is None else env
    if env.get("MINISCHED_CACHE", "1") == "0":
        return None
    chosen = cache_dir or env.get("MINISCHED_CACHE_DIR")
    if not chosen:
        return _DEFAULT_DIR
    return Path(chosen) / _machine_key()


def enable_persistent_cache(cache_dir: Optional[str] = None
                            ) -> Optional[str]:
    """Point the kernels' build at the directory the knobs give (see the
    module docstring) and return it, or None when ``MINISCHED_CACHE=0``
    (the build then goes to a temporary directory removed at exit).
    Idempotent; the last call before the first build wins."""
    from minisched_tpu_torch.utils import build

    resolved = resolve_cache_dir(cache_dir)
    if resolved is None:
        build.set_build_dir(_temporary_dir())
        return None
    resolved.mkdir(parents=True, exist_ok=True)
    build.set_build_dir(resolved)
    return str(resolved)


def default_build_dir() -> Path:
    """The directory a build uses when no call set one: the knobs read
    from the environment now (a temporary directory for
    ``MINISCHED_CACHE=0``)."""
    resolved = resolve_cache_dir()
    return _temporary_dir() if resolved is None else resolved
