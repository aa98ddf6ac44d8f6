"""Build and load the package's CUDA kernels (csrc/*.cu).

Each source compiles with nvcc for sm_90a into its own shared library
with a plain C interface, loaded with ctypes.  The build happens at first
use, from the checkout's own sources, into `_build/<hash>/` beside this
file, where the hash covers the sources and the flags, so an edited
kernel never loads a stale library.  `build_all()` starts one nvcc per
source at once; the engine loop calls kernels from its own thread, so
loading takes a lock.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
SOURCES = {"flash_fwd": "flash_fwd.cu", "flash_bwd": "flash_bwd.cu",
           "paged_decode": "paged_decode.cu"}
# The `dtype` argument every C entry takes.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# Seconds each library took to build in this process (0.0 = reused).
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (PATH or CUDA_HOME)")


def _paths(name: str) -> tuple[str, str, str]:
    src = os.path.join(_CSRC, SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    out_dir = os.path.join(_BUILD, digest.hexdigest()[:16])
    return src, out_dir, os.path.join(out_dir, f"lib{name}.so")


def _start(name: str):
    """Start nvcc for one source; returns (Popen, tmp, so, log) or None
    when the library is already built."""
    src, out_dir, so = _paths(name)
    if os.path.exists(so):
        return None
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    log = os.path.join(out_dir, f"{name}.nvcc.log")
    with open(log, "w") as lf:
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                stdout=lf, stderr=subprocess.STDOUT)
    return proc, tmp, so, log


def _finish(name: str, job, t0: float) -> None:
    proc, tmp, so, log = job
    rc = proc.wait()
    if rc != 0:
        with open(log) as f:
            raise RuntimeError(f"nvcc failed for {SOURCES[name]} (rc {rc}):\n"
                               + f.read()[-4000:])
    os.replace(tmp, so)
    build_seconds[name] = time.perf_counter() - t0


def _build_missing() -> None:
    """Build every library not on disk yet: one nvcc per source, all
    started together.  Caller holds _lock."""
    t0 = time.perf_counter()
    jobs = {n: _start(n) for n in SOURCES}
    for name, job in jobs.items():
        if job is None:
            build_seconds.setdefault(name, 0.0)
        else:
            _finish(name, job, t0)


def build_all() -> dict[str, float]:
    """Build every kernel library now; returns the seconds each took."""
    with _lock:
        _build_missing()
        return dict(build_seconds)


def nvcc_log(name: str) -> str:
    """ptxas register / shared-memory report of the last build."""
    log = os.path.join(_paths(name)[1], f"{name}.nvcc.log")
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


def library(name: str) -> ctypes.CDLL:
    """The loaded library for one kernel source, built if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build_missing()
            lib = _libs[name] = ctypes.CDLL(_paths(name)[2])
        return lib


def function(name: str, symbol: str, argtypes: list):
    """A C entry of one kernel library, with its argument types declared
    (ctypes.c_void_p for pointers and the stream) and an int result."""
    fn = getattr(library(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
