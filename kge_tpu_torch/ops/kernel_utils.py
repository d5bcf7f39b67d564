"""Building and loading the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface under
``build/kernels/`` at the root of the checkout, and loaded with ``ctypes``.
The library's file name carries a hash of its sources, so an edited kernel
is rebuilt and an unchanged one is reused. Nothing here runs at import
time: the CPU tests import every module and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE_DIR), "build", "kernels")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libraries: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

#: per kernel source: seconds its build took in this process (0.0 when the
#: library was already built) and the compiler's resource report
build_seconds: Dict[str, float] = {}
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of kge_tpu_torch are built on "
        "first use and need the CUDA toolkit"
    )


def _sources(name: str):
    main = os.path.join(CSRC_DIR, f"{name}.cu")
    headers = sorted(
        os.path.join(CSRC_DIR, f)
        for f in os.listdir(CSRC_DIR) if f.endswith(".cuh")
    )
    return main, headers


def library_path(name: str) -> str:
    main, headers = _sources(name)
    digest = hashlib.sha1()
    for path in [main] + headers:
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library's path. Raises with the compiler's output when nvcc fails."""
    path = library_path(name)
    if os.path.exists(path):
        build_seconds.setdefault(name, 0.0)
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    main, _ = _sources(name)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    start = time.perf_counter()
    proc = subprocess.run(
        [_nvcc()] + NVCC_FLAGS + ["-I", CSRC_DIR, "-o", tmp, main],
        capture_output=True, text=True,
    )
    build_seconds[name] = time.perf_counter() - start
    build_log[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {main}:\n{build_log[name]}")
    os.replace(tmp, path)
    return path


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libraries.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _libraries[name] = lib
        return lib


def check_launch(code: int, kernel: str) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {code}")


def typed(lib: ctypes.CDLL, name: str, argtypes):
    """The C function ``name`` of ``lib`` with its argument types set (once);
    every launch function returns a CUDA error code."""
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def require(name: str, x, device, dtype) -> None:
    """Raise unless tensor ``x`` is a contiguous ``dtype`` tensor on
    ``device``: the kernels read raw pointers."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
