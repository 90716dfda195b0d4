"""Build the package's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface.  ``load(name)``
compiles it with ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``build/torch_kernels/`` at the repository root, named by a hash of
the source and the flags so an edited source never loads a stale
library, and returns the ``ctypes.CDLL``.  Nothing here runs at import
time: a machine without ``nvcc`` imports the package and uses the plain
PyTorch versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()                    # guards the two dicts
_NAME_LOCKS: dict[str, threading.Lock] = {}  # one build at a time per name
_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, compiling it first if no
    library for this exact source exists yet, keeping ptxas's report of its
    registers and spills beside it (``lib<name>-<hash>.ptxas.txt``).  Loads
    of different names compile concurrently."""
    with _LOCK:
        name_lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with name_lock:
        lib = _LOADED.get(name)
        if lib is not None:
            return lib
        out = library_path(name)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            report = tmp.with_suffix(".ptxas")
            report.write_text(proc.stderr)
            os.replace(report, out.with_suffix(".ptxas.txt"))
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        with _LOCK:
            _LOADED[name] = lib
        return lib


def load_all(names) -> dict[str, float]:
    """Load every ``csrc/<name>.cu`` of ``names``, one nvcc each, all
    started together; returns the seconds each load took."""
    def timed(name):
        t0 = time.perf_counter()
        load(name)
        return time.perf_counter() - t0

    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(timed, names)))


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if the C launcher of ``csrc/<name>.cu`` returned a CUDA error
    code (each library exports ``<name>_error_string``)."""
    if err != 0:
        fn = getattr(lib, f"{name}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({fn(err).decode()})")
