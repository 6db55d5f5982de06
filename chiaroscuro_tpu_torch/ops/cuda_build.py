"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<stem>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``chiaroscuro_tpu_torch/_build/lib<stem>_<hash>.so`` at first use, where the
hash covers the source, the shared headers (``csrc/*.cuh``) and the flags,
so an edited source is rebuilt and an unchanged one is reused.  The library
has a plain C interface and is loaded with ``ctypes``; :func:`bind` declares
the argument types the caller gives, and :func:`check_launch` turns a
launch's error code into an exception.  A failed build raises with nvcc's
output: there is no fallback.

:func:`build_host_library` does the same for a host source
``csrc/<stem>.cpp`` with the host compiler (``g++ -O2 -shared -fPIC``): the
native BVH builder and the OpenEXR shim, which need no card and have
pure-Python stand-ins.  A failed host build is recorded beside the library
(``lib<stem>_<hash>.failed``, holding the compiler's output), so later
processes raise at once instead of compiling again; delete the file to
retry.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {home}/bin and on PATH); the CUDA "
            "kernels cannot be built"
        )
    return found


HOST_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def _compile(compiler: str, flags: tuple, source: str, stem: str, libs: tuple = (),
             remember_failure: bool = False) -> tuple:
    """Compile ``source`` (hashed with the compiler, ``flags``, ``libs`` and
    the shared headers) into ``_build/lib<stem>_<hash>.so`` unless that
    library exists, and load it; ``libs`` follow the source on the command
    line.  Returns ``(lib, info)`` as :func:`build_library` does; a failed
    compile raises with the compiler's output.  With ``remember_failure``
    that output is also kept in ``_build/lib<stem>_<hash>.failed``, and
    while that file exists the compile is not tried again: the call raises
    with the output kept."""
    digest = hashlib.sha256(" ".join((compiler,) + flags + libs).encode())
    for path in [source] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    so = os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")
    failed = so[:-len(".so")] + ".failed"
    if remember_failure and not os.path.exists(so) and os.path.exists(failed):
        with open(failed) as f:
            first, _, rest = f.read().partition("\n")
        raise RuntimeError(f"{first} (an earlier build; delete {failed} to retry)\n{rest}")
    seconds, report = 0.0, ""
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [compiler, *flags, "-o", tmp, source, *libs],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            msg = (f"{os.path.basename(compiler)} failed ({proc.returncode}) building "
                   f"{source}:\n{proc.stderr}{proc.stdout}")
            if remember_failure:
                fd, note = tempfile.mkstemp(suffix=".failed", dir=BUILD_DIR)
                with os.fdopen(fd, "w") as f:
                    f.write(msg)
                os.replace(note, failed)
            raise RuntimeError(msg)
        os.replace(tmp, so)
        report = proc.stderr + proc.stdout
    return ctypes.CDLL(so), {"path": so, "seconds": seconds, "ptxas": report}


@functools.cache
def build_library(stem: str) -> tuple:
    """Build (once per source, headers and flags) and load
    ``csrc/<stem>.cu``.

    Returns ``(lib, info)`` where ``info`` holds the library path, the build
    seconds (0.0 when an earlier build was reused) and nvcc's ``-Xptxas -v``
    report.  Safe to call for different stems from several threads at once
    (each nvcc runs as its own process)."""
    return _compile(nvcc(), NVCC_FLAGS, os.path.join(CSRC_DIR, f"{stem}.cu"), stem)


@functools.cache
def build_host_library(stem: str, flags: tuple = (), libs: tuple = ()) -> tuple:
    """Build (once per source and flags) and load the host source
    ``csrc/<stem>.cpp`` with ``g++`` (``$CXX`` where set), with ``flags``
    (include paths) after HOST_FLAGS and ``libs`` (``-l`` options) after
    the source.  Returns ``(lib, info)`` as :func:`build_library`; a failed
    build raises, and is recorded so that later calls raise without
    compiling (module docstring)."""
    compiler = os.environ.get("CXX") or shutil.which("g++")
    if compiler is None:
        raise RuntimeError("g++ not found on PATH; the host library cannot be built")
    return _compile(compiler, HOST_FLAGS + tuple(flags),
                    os.path.join(CSRC_DIR, f"{stem}.cpp"), stem, tuple(libs),
                    remember_failure=True)


def bind(stem: str, launches: dict) -> tuple:
    """:func:`build_library`, then the argument types of each launch entry
    point in ``launches`` ({symbol: argtypes}; each returns a CUDA error
    code) and of ``<stem>_error_string``, which every ``csrc`` library
    exports.  Returns ``(lib, info)``; :func:`check_launch` reads the
    error string."""
    lib, info = build_library(stem)
    for symbol, argtypes in launches.items():
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.error_string = getattr(lib, f"{stem}_error_string")
    lib.error_string.argtypes, lib.error_string.restype = [ctypes.c_int], ctypes.c_char_p
    return lib, info


def check_launch(lib, err: int, name: str) -> None:
    """Raise unless a launch entry point of a :func:`bind` library returned
    0 (cudaSuccess)."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.error_string(err).decode()})")
