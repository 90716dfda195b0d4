"""ctypes bindings to the native C++ host engine (native/arrowspace_host.cpp,
port of pyarrowspace_tpu/io/native.py).

The library is built with g++ at first use, from the source where it lies
in the repository, into ``build/native/`` at the repository root (git
ignores it), named by a hash of the source, the flags and the host CPU
(``-march=native``), so an edited source never loads a stale library and a
tree copied to another machine builds its own.  Every entry point returns
None (or False) when the toolchain or the library is missing; only the
build's ``ARROWSPACE_SYMMETRIZE=host`` mode turns that into an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..utils.logging import get_logger

log = get_logger("native")

_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _ROOT / "native" / "arrowspace_host.cpp"
BUILD_DIR = _ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-fPIC", "-shared",
             "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _cpu_identity() -> str:
    """The machine, CPU model and instruction-set flags that -march=native
    compiles for (/proc/cpuinfo's first processor; the machine name alone
    where that file is missing)."""
    ident = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags", "Features", "CPU part"):
                    ident.append(line.strip())
                elif not line.strip() and len(ident) > 1:
                    break
    except OSError:
        ident.append(platform.processor())
    return "\n".join(ident)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_identity().encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libarrowspace_host-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    # Build to a process-unique temp path and rename: concurrent first use
    # across processes (pytest-xdist workers) must never load a
    # half-written library (rename is atomic on POSIX).
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.{os.getpid()}")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        log.info("built %s", out)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        log.warning("native build failed: %s", e)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, built at first use; None if unavailable."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if not SOURCE.exists():
            _load_failed = True
            return None
        path = library_path()
        if not path.exists() and not _build(path):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            log.warning("native load failed: %s", e)
            _load_failed = True
            return None
        lib.asx_scan_validate.restype = ctypes.c_int
        lib.asx_scan_validate.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.asx_knn_f64.restype = ctypes.c_int
        lib.asx_knn_f64.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_double,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32)]
        lib.asx_symmetrize_ell.restype = ctypes.c_int
        lib.asx_symmetrize_ell.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64)]
        lib.asx_write_blob.restype = ctypes.c_int
        lib.asx_write_blob.argtypes = [ctypes.c_char_p,
                                       ctypes.POINTER(ctypes.c_uint8),
                                       ctypes.c_uint64]
        lib.asx_blob_size.restype = ctypes.c_int64
        lib.asx_blob_size.argtypes = [ctypes.c_char_p]
        lib.asx_read_blob.restype = ctypes.c_int
        lib.asx_read_blob.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_uint8),
                                      ctypes.c_uint64]
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def scan_validate(data: np.ndarray) -> Optional[tuple[int, int]]:
    """(nan_count, inf_count) via the OpenMP scan; None if unavailable."""
    lib = get_lib()
    if lib is None or data.dtype != np.float64:
        return None
    arr = np.ascontiguousarray(data)
    nan_c, inf_c = ctypes.c_int64(0), ctypes.c_int64(0)
    rc = lib.asx_scan_validate(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        arr.shape[0], arr.shape[1], ctypes.byref(nan_c), ctypes.byref(inf_c))
    if rc != 0:
        return None
    return nan_c.value, inf_c.value


def knn_host(data: np.ndarray, k: int, eps: float
             ) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """Exact host-side eps/k-NN in float64 (OpenMP), the golden engine.
    Returns (dist [n,k] f64, idx [n,k] int32) or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    arr = np.ascontiguousarray(data, dtype=np.float64)
    n, f = arr.shape
    out_d = np.empty((n, k), dtype=np.float64)
    out_i = np.empty((n, k), dtype=np.int32)
    rc = lib.asx_knn_f64(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, f, k,
        float(eps), out_d.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out_i.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        return None
    return out_d, out_i


def symmetrize_host(idx: np.ndarray, w: np.ndarray, ell_width: int
                    ) -> Optional[tuple[np.ndarray, np.ndarray, int]]:
    """Host OpenMP symmetrize-to-ELL with ops/symmetrize.py's exact
    semantics.  Returns (nbr_idx [n,m] int32, nbr_w [n,m] f64, n_dropped)
    or None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    idx_c = np.ascontiguousarray(idx, dtype=np.int32)
    w_c = np.ascontiguousarray(w, dtype=np.float64)
    n, k = idx_c.shape
    m = int(ell_width)
    out_i = np.empty((n, m), dtype=np.int32)
    out_w = np.empty((n, m), dtype=np.float64)
    dropped = ctypes.c_int64(0)
    rc = lib.asx_symmetrize_ell(
        idx_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        w_c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n, k, m,
        out_i.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_w.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(dropped))
    if rc != 0:
        return None
    return out_i, out_w, dropped.value


def write_blob(path: str, payload: bytes) -> bool:
    lib = get_lib()
    if lib is None:
        return False
    buf = (ctypes.c_uint8 * len(payload)).from_buffer_copy(payload)
    return lib.asx_write_blob(path.encode(), buf, len(payload)) == 0


def blob_size(path: str) -> Optional[int]:
    """The payload bytes of the blob at ``path``; None if it is no blob or
    the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    size = lib.asx_blob_size(path.encode())
    return None if size < 0 else int(size)


def read_blob(path: str) -> Optional[bytes]:
    lib = get_lib()
    size = blob_size(path)
    if size is None:
        return None
    out = (ctypes.c_uint8 * size)()
    if lib.asx_read_blob(path.encode(), out, size) != 0:
        return None
    return bytes(out)
