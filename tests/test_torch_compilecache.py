"""Where the port builds its kernels: ``utils/compilecache.py``'s knobs.

JAX's ``MINISCHED_CACHE=0`` and ``MINISCHED_CACHE_DIR``
(``minisched_tpu/utils/compilecache.py:58-88``) act on the port's nvcc
build (``utils/build.py``) as they act on JAX's executable cache: off, a
relocated directory namespaced by the machine (``<dir>/<machine>``, the
same key as JAX's), or the default ``minisched_tpu_torch/_build``.  The
builds run with ``find_nvcc`` and ``subprocess`` stubbed, so no card and
no nvcc are needed: the stubs write the object files and the library
where nvcc would.
"""

from __future__ import annotations

import os
from pathlib import Path

import pytest

from minisched_tpu.utils import compilecache as jcache

from minisched_tpu_torch.utils import build, compilecache


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """``build`` with nothing chosen or loaded, nvcc stubbed: each
    compile writes its ``-o`` file, the link writes the library.  The
    default directory moves under ``tmp_path`` (no stub may land in the
    package's real ``_build``)."""
    monkeypatch.setattr(compilecache, "_DEFAULT_DIR",
                        tmp_path / "default" / "_build")
    monkeypatch.setattr(build, "_build_dir", None)
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "find_nvcc", lambda: "/stub/nvcc")
    calls = []

    def write_out(cmd):
        out = Path(cmd[cmd.index("-o") + 1])
        out.write_bytes(b"stub")
        calls.append(cmd)

    class Proc:
        returncode = 0

        def __init__(self, cmd, **_kw):
            write_out(cmd)

        def communicate(self):
            return "ok", None

    class Done:
        returncode = 0
        stdout = stderr = ""

    def run(cmd, **_kw):
        write_out(cmd)
        return Done()

    monkeypatch.setattr(build.subprocess, "Popen", Proc)
    monkeypatch.setattr(build.subprocess, "run", run)
    return calls


def test_machine_key_is_jax_s():
    assert compilecache._machine_key() == jcache._machine_key()


@pytest.mark.parametrize("env, cache_dir, where", [
    ({}, None, "default"),
    ({"MINISCHED_CACHE_DIR": "{tmp}/cache"}, None, "relocated"),
    ({}, "{tmp}/arg", "relocated"),
    ({"MINISCHED_CACHE_DIR": "{tmp}/env"}, "{tmp}/arg", "relocated"),
    ({"MINISCHED_CACHE": "0"}, None, "off"),
    ({"MINISCHED_CACHE": "0", "MINISCHED_CACHE_DIR": "{tmp}/x"}, None, "off"),
    ({"MINISCHED_CACHE": "1"}, None, "default"),
])
def test_knobs_choose_the_build_directory(monkeypatch, tmp_path, fresh_build,
                                          env, cache_dir, where):
    """The directory ``enable_persistent_cache`` returns and the one the
    build lands in, knob by knob, as JAX's rule gives them: a relocated
    one is ``<dir>/<machine key>``, an argument wins over the
    environment, ``MINISCHED_CACHE=0`` wins over both."""
    for key in ("MINISCHED_CACHE", "MINISCHED_CACHE_DIR"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value.format(tmp=tmp_path))
    arg = cache_dir.format(tmp=tmp_path) if cache_dir else None
    got = compilecache.enable_persistent_cache(arg)
    lib = build.build()
    assert fresh_build, "the stubbed nvcc was never called"
    assert lib.name == build.LIB_NAME and lib.exists()
    assert lib.parent.parent == build.build_dir()
    if where == "off":
        assert got is None
        assert build.build_dir().name.startswith("minisched-kernels-")
        assert not str(build.build_dir()).startswith(str(tmp_path))
    elif where == "default":
        assert got == str(compilecache._DEFAULT_DIR)
        assert build.build_dir() == compilecache._DEFAULT_DIR
    else:
        want = Path(arg or env["MINISCHED_CACHE_DIR"].format(tmp=tmp_path))
        assert got == str(want / jcache._machine_key())
        assert build.build_dir() == want / jcache._machine_key()


def test_build_without_a_call_reads_the_environment(monkeypatch, tmp_path,
                                                    fresh_build):
    monkeypatch.delenv("MINISCHED_CACHE", raising=False)
    monkeypatch.setenv("MINISCHED_CACHE_DIR", str(tmp_path))
    lib = build.build()
    assert lib.parent.parent == tmp_path / compilecache._machine_key()


def test_cache_off_directory_is_removed_at_exit(monkeypatch, fresh_build):
    """``MINISCHED_CACHE=0``: the temporary directory is registered for
    removal at exit (the registered call is run here)."""
    registered = []
    monkeypatch.setattr(compilecache.atexit, "register",
                        lambda fn, *a, **kw: registered.append((fn, a, kw)))
    monkeypatch.setenv("MINISCHED_CACHE", "0")
    assert compilecache.enable_persistent_cache() is None
    lib = build.build()
    assert lib.exists()
    (fn, args, kw), = registered
    fn(*args, **kw)
    assert not os.path.exists(build.build_dir())


def test_a_built_library_is_not_built_again(monkeypatch, tmp_path,
                                            fresh_build):
    monkeypatch.setenv("MINISCHED_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("MINISCHED_CACHE", raising=False)
    compilecache.enable_persistent_cache()
    first = build.build()
    n = len(fresh_build)
    assert build.build() == first and len(fresh_build) == n
