"""Build and load the port's CUDA kernels.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` into one shared library
with a plain C interface, loaded with ctypes. The library lands in
``_build/`` under a name keyed by a hash of the sources and flags, so a later
run with the same sources loads it without building. Nothing here runs at
import time: the CPU tests import every module on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def sources() -> list:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith(".cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set NVCC or CUDA_HOME, or put nvcc "
                       "on PATH")


def build() -> str:
    """Compile the kernels if no library for these sources exists yet.

    Returns the library's path. nvcc's own output (ptxas resource usage)
    is kept beside it with the suffix ``.log``. Raises RuntimeError with
    nvcc's output when the build fails."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD, f"fastk_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources()],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {r.returncode}:\n"
                           f"{r.stdout}{r.stderr}")
    with open(so + ".log", "w") as f:
        f.write(r.stdout + r.stderr)
    os.replace(tmp, so)
    return so


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    lib = ctypes.CDLL(build())
    lib.fk_run_hist.restype = ctypes.c_int
    lib.fk_run_hist.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                ctypes.c_longlong, ctypes.c_void_p,
                                ctypes.c_void_p]
    lib.fk_run_hist_blocks_per_sm.restype = ctypes.c_int
    lib.fk_run_hist_blocks_per_sm.argtypes = []
    lib.fk_cuda_error_string.restype = ctypes.c_char_p
    lib.fk_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def check(err: int, what: str) -> None:
    """Raise when a kernel's C entry point returned a CUDA error."""
    if err:
        msg = load().fk_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
