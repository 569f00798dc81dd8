"""Build and load the port's CUDA kernels.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` into one shared library
with a plain C interface, loaded with ctypes: one ``nvcc -c`` a source, all
started together, then one link. The library lands in
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


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
    nvcc = _nvcc()
    tmp = f"{so}.{os.getpid()}"
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources()]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources(), objs)]
    logs = [p.communicate()[0] for p in procs]
    try:
        for p, src, log in zip(procs, sources(), logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {os.path.basename(src)} "
                                   f"with exit code {p.returncode}:\n{log}")
        r = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp + ".tmp",
                            *objs], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed to link with exit code "
                               f"{r.returncode}:\n{r.stdout}{r.stderr}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.unlink(obj)
    with open(so + ".log", "w") as f:
        f.write("".join(logs))
    os.replace(tmp + ".tmp", so)
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
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name, args in (
            ("fk_probe_hist", [ptr, i64, i32, i32, ptr, ptr]),
            ("fk_probe_loop", [ptr, i32, i32, ptr, i32, ptr, ptr]),
            ("fk_probe_bits", [ptr, i64, i32, i32, ptr, ptr]),
            ("fk_probe_carry", [ptr, i64, i64, ptr, ptr, ptr])):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = args
    lib.fk_probe_loop_threads.restype = ctypes.c_int
    lib.fk_probe_loop_threads.argtypes = [i32, i32, i32,
                                          ctypes.POINTER(ctypes.c_int)]
    return lib


def check(err: int, what: str) -> None:
    """Raise when a kernel's C entry point returned a CUDA error."""
    if err:
        msg = load().fk_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
