"""Build and load the port's shared libraries on first use.

Two libraries live in ``tpu_spmv_torch/_build/`` (listed in ``.gitignore``;
nothing prebuilt is committed):

* ``libtpu_spmv_kernels.so``: the CUDA kernels of ``tpu_spmv_torch/csrc/*.cu``,
  compiled by ``nvcc`` for ``sm_90a`` with a plain C interface and loaded
  with ctypes (no PyTorch headers, so a build takes seconds);
* ``libtpu_spmv_native.so``: the host planner library (see
  :mod:`tpu_spmv_torch.native.build`).

A library is built when it is missing or older than one of its sources, never
at import.  Concurrent first builds (several test workers, several processes
on one card) serialize on a file lock, and each build writes a temporary file
that ``os.replace`` moves into place, so no process ever loads a half-written
library.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import glob
import os
import shutil
import subprocess
from typing import Callable, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
KERNELS_LIB = "libtpu_spmv_kernels.so"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _fresh(out: str, sources: Sequence[str]) -> bool:
    return os.path.exists(out) and all(
        os.path.getmtime(out) >= os.path.getmtime(s) for s in sources)


def build_library(name: str, sources: Sequence[str],
                  command: Callable[[str], list]) -> str:
    """Build ``_build/<name>`` from ``sources`` unless it is up to date.

    ``command(out_path)`` returns the compiler command line writing to
    ``out_path``.  The compiler's output is kept in ``_build/<name>.log``.
    Raises ``RuntimeError`` with the compiler's message when it fails."""
    out = os.path.join(BUILD_DIR, name)
    if _fresh(out, sources):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _fresh(out, sources):    # another process built it meanwhile
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = command(tmp)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        with open(out + ".log", "w") as log:
            log.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(
                f"building {name} failed (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built on this machine")


def kernel_sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def build_kernels() -> str:
    """Compile ``csrc/*.cu`` into the kernels library; returns its path."""
    srcs = kernel_sources()
    nvcc = nvcc_path()
    return build_library(
        KERNELS_LIB, srcs, lambda out: [nvcc, *NVCC_FLAGS, "-o", out, *srcs])


_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64


@functools.cache
def kernels() -> ctypes.CDLL:
    """The loaded kernels library (built on the first call)."""
    lib = ctypes.CDLL(build_kernels())
    # every pointer and the stream as c_void_p: a bare Python int would be
    # passed as a 32-bit int and cut the address
    lib.tsp_window_ell_fold.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P]
    lib.tsp_window_ell_fold.restype = _I
    lib.tsp_unpermute.argtypes = [_P, _I64, _P, _P, _I64, _P]
    lib.tsp_unpermute.restype = _I
    return lib
