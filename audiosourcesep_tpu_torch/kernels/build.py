"""Compile ``csrc/*.cu`` with nvcc into one shared library and load it.

The sources expose a plain C interface, so they are compiled without
PyTorch's headers (seconds, not minutes) and bound with ``ctypes``. The
library is built at first use into ``kernels/_build/`` (listed in
``.gitignore``) and cached by a hash of the sources and the flags; a
second process finds the finished ``.so`` and only loads it.

A missing ``nvcc`` or a failed build raises, with nvcc's output in the
message. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "kernels" / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature of every exported function: name -> (argtypes, restype).
# Pointers and the stream are c_void_p; every int is c_int.
SIGNATURES = {
    # (x, u, y, B, H, W, Cin, Cout, dtype, stream) -> cudaError_t
    "winograd_f23_fwd": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _P], _I),
}

_lib = None
build_log = ""      # nvcc's output (ptxas register/shared-memory report)


def _sources() -> list:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def build() -> Path:
    """Compile the kernels if no library for the current sources exists;
    return the path of the shared library."""
    global build_log
    sources = [s for s in _sources() if s.suffix == ".cu"]
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    so = BUILD_DIR / f"libasrkernels_{_digest(_sources())}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{build_log}")
    os.replace(tmp, so)      # atomic: a concurrent loader sees all or none
    return so


def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, argtypes set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib
