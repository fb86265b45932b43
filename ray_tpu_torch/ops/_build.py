"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded through ``ctypes``
(no PyTorch headers, so a build takes seconds). Builds happen at first
use, from the sources in the checkout, into ``ops/_build/`` (listed in
``.gitignore``); a library is named by the hash of its source, the shared
``csrc/*.cuh`` headers and the flags, so an edited source or header builds
anew. Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

# kernel name -> source file under csrc/
SOURCES: Dict[str, str] = {"flash_fwd": "flash_fwd.cu", "flash_bwd": "flash_bwd.cu"}

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def lib_path(name: str) -> str:
    """Library path of kernel ``name``, named by the hash of its source, the
    shared headers (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [SOURCES[name], *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns seconds per kernel built (0.0 for
    one already built). Raises with the compiler's output on failure. The
    ``-Xptxas -v`` report (registers, shared memory, spills) is kept beside
    each library as ``<lib>.log``."""
    names = list(SOURCES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    procs = {}
    seconds: Dict[str, float] = {}
    for name in names:
        out = lib_path(name)
        if os.path.exists(out):
            seconds[name] = 0.0
            continue
        nvcc = nvcc or nvcc_path()
        # Unique temp name, renamed into place: concurrent builders never
        # load a half-written library.
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        with open(out + ".log", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {SOURCES[name]}:\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(lib_path(name))
            _libs[name] = lib
        return lib
