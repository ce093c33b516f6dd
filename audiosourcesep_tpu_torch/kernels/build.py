"""Compile ``csrc/*.cu`` with nvcc into one shared library and load it.

The sources expose a plain C interface, so they are compiled without
PyTorch's headers (seconds, not minutes) and bound with ``ctypes``. Each
source is compiled by its own nvcc, all started together, and the
objects are linked into one library. It is built at first use into
``kernels/_build/`` (listed in ``.gitignore``) and cached by a hash of
the sources and the flags; a second process finds the finished ``.so``
and only loads it. nvcc's output (ptxas' registers, spills and shared
memory per kernel) is kept beside the library as ``.log`` and read back
into :data:`build_log` on a cached build.

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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature of every exported function: name -> (argtypes, restype).
# Pointers and the stream are c_void_p; every int is c_int.
SIGNATURES = {
    # (x, u, y, B, H, W, Cin, Cout, dilation, block_rows, stream)
    #   -> cudaError_t
    "winograd_f23_fwd_f32": ([_P, _P, _P, *[_I] * 7, _P], _I),
    # (x, u, y, B, H, W, Cin, Cout, dilation, path (0 thin_in, 1
    #  thin_out), box images, box tile rows, box tile columns, split
    #  (thin_out's cluster, thin_in's tile warps), channel warps, stream)
    #  -> cudaError_t
    "winograd_f23_fwd_f32_thin": ([_P, _P, _P, *[_I] * 12, _P], _I),
    # (x, u, y, B, H, W, Cin, Cout, U's row length, dilation, row phases
    #  P, tile columns TC, tma, stream) -> cudaError_t
    "winograd_f23_fwd_bf16": ([_P, _P, _P, *[_I] * 10, _P], _I),
    # () -> dynamic shared memory bytes per block of each kernel
    "winograd_f23_f32_smem_bytes": ([], _I),
    "winograd_f23_bf16_smem_bytes": ([], _I),
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
    log = so.with_suffix(".log")
    if so.exists():
        build_log = log.read_text() if log.exists() else ""
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = find_nvcc(), f"{os.getpid()}.tmp"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
            for src, o in zip(sources, objs)]
    cmds.append([nvcc, "-shared", "-o", str(so.with_suffix(f".{tag}")),
                 *map(str, objs)])
    try:
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds[:-1]]
        outs = [p.communicate()[0] for p in procs]
        logs = [f"$ {' '.join(c)}\n{out}" for c, out in zip(cmds, outs)]
        failed = [c for c, p in zip(cmds, procs) if p.returncode != 0]
        if not failed:
            link = subprocess.run(cmds[-1], capture_output=True, text=True)
            logs.append(f"$ {' '.join(cmds[-1])}\n{link.stdout}{link.stderr}")
            if link.returncode != 0:
                failed = [cmds[-1]]
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed: {' '.join(failed[0])}\n"
                               f"{build_log}")
        log.write_text(build_log)
        # atomic: a concurrent loader sees all or none
        os.replace(so.with_suffix(f".{tag}"), so)
    finally:
        for path in (*objs, so.with_suffix(f".{tag}")):
            path.unlink(missing_ok=True)
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
