"""The environment the program builds for itself: the native library built
from source on first use, and the JAX compilation-cache location."""

import ctypes
import os
import shutil
import subprocess
import sys

import jax
import pytest

from iamf_tpu import native
from iamf_tpu.utils import compile_cache


def test_concurrent_first_builds_agree(tmp_path):
    """Six processes that find no library build it at once, as parallel
    test workers do: the lock serialises make, every process gets a
    complete library, and the build leaves no temporary file behind."""
    src = tmp_path / "native"
    shutil.copytree(native.NATIVE_DIR, src,
                    ignore=shutil.ignore_patterns("lib"))
    code = ("import ctypes, sys; from iamf_tpu import native; "
            "native.build(sys.argv[1]); "
            "lib = ctypes.CDLL(sys.argv[1] + '/lib/libiamf_native.so'); "
            "print(lib.iamf_obu_split_all is not None)")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(native.NATIVE_DIR))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(6)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "True"
    assert sorted(os.listdir(src / "lib")) == [
        ".build.lock", native.COFF_RUNTIME, native.NATIVE_LIB]


def test_load_declares_fresh_handles():
    a, b = native.load(), native.load()
    assert isinstance(a, ctypes.CDLL) and a is not b
    assert os.path.exists(native.lib_path(native.COFF_RUNTIME))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("env_dir", [None, "/somewhere/else"])
def test_compile_cache_location(env_dir, monkeypatch, restore_cache_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is left for JAX to read and
    nothing is set in code; otherwise the cache is <repo>/.jax_cache."""
    jax.config.update("jax_compilation_cache_dir", None)
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    got = compile_cache.enable_compile_cache()
    if env_dir is None:
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert got == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    else:
        assert got == env_dir
        assert jax.config.jax_compilation_cache_dir is None
