"""The native host libraries, built from ``native/src`` on first use.

``make -C native`` is incremental, so a checkout that holds no library (or
an outdated one) builds it here. The build runs under an exclusive file
lock, because parallel processes (test workers) would otherwise race to
build the same files, and the Makefile installs each library by atomic
rename, so a process never maps a half-written ``.so``.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import os
import subprocess

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
NATIVE_LIB = "libiamf_native.so"    # codecs, OBU splitter, device-kernel taps
COFF_RUNTIME = "libiamf_coffrt.so"  # loader runtime for the fdk COFF oracle


def build(native_dir: str = NATIVE_DIR) -> None:
    """Bring ``native_dir/lib`` up to date with its sources (``make -C``),
    holding an exclusive lock on ``lib/.build.lock`` while make runs."""
    lib_dir = os.path.join(native_dir, "lib")
    os.makedirs(lib_dir, exist_ok=True)
    with open(os.path.join(lib_dir, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        res = subprocess.run(["make", "-C", native_dir],
                             capture_output=True, text=True)
    if res.returncode != 0:
        raise OSError(f"make -C {native_dir} failed "
                      f"({res.returncode}):\n{res.stderr[-4000:]}")


_build_once = functools.cache(build)


def lib_path(name: str = NATIVE_LIB) -> str:
    """Path of an up-to-date native library (built on the first call)."""
    _build_once()
    return os.path.join(NATIVE_DIR, "lib", name)


def load(name: str = NATIVE_LIB) -> ctypes.CDLL:
    """A fresh ctypes handle on the library. Callers declare ``argtypes``
    and ``restype`` for every function they use on their own handle."""
    return ctypes.CDLL(lib_path(name))
