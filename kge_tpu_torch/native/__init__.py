"""Host-side data plane in C++ (``kge_native.cpp``), bound with ctypes.

The package's own copy of ``kge_tpu/native``: the same three entry points
(``parse_triples``, ``where_in``, ``filter_resample``) with the same
results and the same draws. Each returns None when the library cannot be
built, and its caller then takes its numpy version: ``parse_triples_numpy``
here (the same grammar), ``indexing.where_in``, and the sampler's batch
filter (``ops/sampler.py``), which draws otherwise, as in kge_tpu.

The library is built on first use with the host's ``g++`` (with OpenMP
where the compiler has it) into ``build/native/`` at the root of the
checkout. Its file name carries a hash of the source, and it is written
under a temporary name and then renamed, so that processes building at
once do not overwrite each other. Nothing is built at import time. Each
entry point counts its calls into the library (``.calls``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "kge_native.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "native",
)
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

#: set by a build in this process: its seconds and whether OpenMP is on
build_info: dict = {}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def library_path() -> str:
    """Where the library of the current source is (or will be) built."""
    digest = hashlib.sha1()
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"kge_native-{digest.hexdigest()[:16]}.so")


def _build(path: str) -> bool:
    """Compile the library to ``path``, first with ``-fopenmp``, then
    without; on failure write the compiler's output to stderr."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
    os.close(fd)
    start = time.perf_counter()
    try:
        for extra in (["-fopenmp"], []):
            try:
                proc = subprocess.run(
                    ["g++", *GXX_FLAGS, *extra, "-o", tmp, SOURCE],
                    capture_output=True, text=True, timeout=240,
                )
            except (OSError, subprocess.TimeoutExpired) as e:
                sys.stderr.write(f"kge_tpu_torch.native: cannot run g++: {e}\n")
                return False
            if proc.returncode == 0:
                os.replace(tmp, path)
                build_info.update(seconds=time.perf_counter() - start,
                                  openmp=bool(extra))
                return True
        sys.stderr.write(
            "kge_tpu_torch.native: g++ failed; the numpy versions run "
            f"instead:\n{proc.stderr[-2000:]}\n"
        )
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            _failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            sys.stderr.write(f"kge_tpu_torch.native: cannot load {path}: {e}\n")
            _failed = True
            return None
        lib.kge_parse_triples.restype = ctypes.c_int64
        lib.kge_parse_triples.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
        ]
        lib.kge_where_in.restype = None
        lib.kge_where_in.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ]
        lib.kge_filter_resample.restype = ctypes.c_int64
        lib.kge_filter_resample.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_uint64,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library is built and loaded (building it if need be).
    Every entry point asks this first, so that patching it off switches
    every caller to its numpy version."""
    return _load() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _parse_error(path: str, code: int) -> ValueError:
    # code: -1 the file cannot be read, -(2 + k) the k-th non-blank line
    # (from 0) is malformed
    return ValueError(f"cannot parse triple file {path!r} (native error {code})")


def parse_triples(path: str) -> Optional[np.ndarray]:
    """Parse a triple file into an [N, 3] int32 array, or None when the
    library is unavailable. Each non-blank line holds three integers
    separated by spaces or tabs (a leading ``-`` allowed); what follows the
    third is ignored; lines of ``\\r`` only are blank. Raises ValueError on
    a malformed line."""
    if not available():
        return None
    parse_triples.calls += 1
    count = _lib.kge_parse_triples(path.encode(), None, 0)
    if count < 0:
        raise _parse_error(path, count)
    out = np.empty((count, 3), dtype=np.int32)
    got = _lib.kge_parse_triples(path.encode(), _ptr(out, ctypes.c_int32), count)
    if got != count:
        raise ValueError(f"inconsistent parse of {path!r}: {got} vs {count}")
    return out


parse_triples.calls = 0

# one line of kge_native.cpp's grammar (possessive, as its loops take all
# they can): optional leading \r, then three integers, or nothing
_LINE = re.compile(
    rb"^\r*+(?:[ \t]*+(-?[0-9]++)[ \t]*+(-?[0-9]++)[ \t]*+(-?[0-9]++)[^\n]*+)?$",
    re.MULTILINE,
)


def parse_triples_numpy(path: str) -> np.ndarray:
    """``parse_triples`` without the library: the same grammar, the same
    values (the C++ reads an int64 and keeps its low 32 bits) and the same
    ValueError."""
    with open(path, "rb") as f:
        data = f.read()
    rows = _LINE.findall(data)
    if len(rows) != data.count(b"\n") + 1:
        triple = 0
        for line in data.split(b"\n"):
            match = _LINE.fullmatch(line)
            if match is None:
                raise _parse_error(path, -(2 + triple))
            triple += match.group(1) is not None
    tokens = np.array([row for row in rows if row[0]], dtype=np.bytes_)
    if tokens.size == 0:
        return np.empty((0, 3), dtype=np.int32)
    if tokens.dtype.itemsize <= 18:
        values = tokens.astype(np.int64)
    else:  # a token may not fit an int64: its low 32 bits, as the C++ keeps
        values = np.array(
            [[int(t) & 0xFFFFFFFF for t in row] for row in tokens.tolist()],
            dtype=np.uint32,
        ).view(np.int32)
    return np.ascontiguousarray(values.astype(np.int32))


def where_in(
    x: np.ndarray, y: np.ndarray, not_in: bool = False
) -> Optional[np.ndarray]:
    """Positions of x (not) contained in y, or None when unavailable."""
    if not available():
        return None
    where_in.calls += 1
    x = np.ascontiguousarray(x, dtype=np.int64)
    y = np.ascontiguousarray(y, dtype=np.int64)
    mask = np.empty(len(x), dtype=np.uint8)
    _lib.kge_where_in(
        _ptr(x, ctypes.c_int64), len(x), _ptr(y, ctypes.c_int64), len(y),
        _ptr(mask, ctypes.c_uint8), int(not_in),
    )
    return np.nonzero(mask)[0]


where_in.calls = 0


def filter_resample(
    samples: np.ndarray,
    rows_idx: np.ndarray,
    offsets: np.ndarray,
    values: np.ndarray,
    vocab: int,
    seed: int,
    cdf: Optional[np.ndarray] = None,
) -> Optional[int]:
    """In-place filtered resampling of ``samples`` [n, m] (int64, C-order):
    entries colliding with their row's CSR positives are redrawn (uniform, or
    from the inclusive ``cdf`` when given) until none does. Row i draws from
    its own splitmix64 stream, seeded ``seed ^ 0x2545F4914F6CDD1D * (i + 1)``,
    so the result does not depend on the number of threads. Returns the
    replacement count, or None when the library is unavailable."""
    if not available():
        return None
    if samples.dtype != np.int64 or not samples.flags.c_contiguous:
        raise ValueError("samples must be a C-contiguous int64 array")
    filter_resample.calls += 1
    rows_idx = np.ascontiguousarray(rows_idx, dtype=np.int64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    values = np.ascontiguousarray(values, dtype=np.int32)
    n, m = samples.shape
    cdf_ptr = None
    if cdf is not None:
        cdf = np.ascontiguousarray(cdf, dtype=np.float64)
        cdf_ptr = cdf.ctypes.data_as(ctypes.c_void_p)
    return int(
        _lib.kge_filter_resample(
            _ptr(samples, ctypes.c_int64), n, m,
            _ptr(rows_idx, ctypes.c_int64), _ptr(offsets, ctypes.c_int64),
            _ptr(values, ctypes.c_int32), vocab, cdf_ptr,
            ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF).value,
        )
    )


filter_resample.calls = 0
