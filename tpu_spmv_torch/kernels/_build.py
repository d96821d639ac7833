"""Build and load the port's shared libraries on first use.

Two libraries live in ``tpu_spmv_torch/_build/`` (listed in ``.gitignore``;
nothing prebuilt is committed):

* ``libtpu_spmv_kernels.so``: the CUDA kernels of ``tpu_spmv_torch/csrc/*.cu``,
  compiled by ``nvcc`` for ``sm_90a`` (one process per source, in parallel)
  with a plain C interface and loaded with ctypes (no PyTorch headers, so a
  build takes seconds);
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _fresh(out: str, sources: Sequence[str]) -> bool:
    return os.path.exists(out) and all(
        os.path.getmtime(out) >= os.path.getmtime(s) for s in sources)


def _run_all(cmds: list) -> list:
    """Run the commands all at once; returns ``(cmd, exit code, output)``
    for each, in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    return [(c, p.returncode, o) for c, p, o in zip(cmds, procs, outs)]


def build_library(name: str, sources: Sequence[str],
                  command: Callable[[str], list],
                  compiles: Callable[[str], list] | None = None) -> str:
    """Build ``_build/<name>`` from ``sources`` unless it is up to date.

    ``command(out_path)`` returns the command line writing the library to
    ``out_path``.  ``compiles(out_path)``, when given, returns command lines
    that run all at once before it (one compile per source, whose objects
    ``command`` links).  Every command's output is kept in
    ``_build/<name>.log``.  Raises ``RuntimeError`` with the compiler's
    message when one fails."""
    out = os.path.join(BUILD_DIR, name)
    if _fresh(out, sources):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _fresh(out, sources):    # another process built it meanwhile
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        pre = compiles(tmp) if compiles else []
        runs = _run_all(pre)
        if all(rc == 0 for _, rc, _ in runs):
            runs += _run_all([command(tmp)])
        text = "".join(" ".join(c) + "\n" + o for c, _, o in runs)
        with open(out + ".log", "w") as log:
            log.write(text)
        for c in pre:                 # the objects, linked or not
            obj = c[c.index("-o") + 1]
            if os.path.exists(obj):
                os.remove(obj)
        failed = [rc for _, rc, _ in runs if rc != 0]
        if failed:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(
                f"building {name} failed (exit {failed[0]}):\n{text}")
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
    """Compile ``csrc/*.cu`` into the kernels library, one ``nvcc`` per
    source, all started together, then link; returns the library's path.
    The headers ``csrc/*.cuh`` are compiled into the sources that include
    them; a change to one rebuilds the library."""
    srcs = kernel_sources()
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    nvcc = nvcc_path()

    def obj(out: str, src: str) -> str:
        return f"{out}.{os.path.basename(src)}.o"

    return build_library(
        KERNELS_LIB, srcs + headers,
        lambda out: [nvcc, *NVCC_FLAGS, "-shared", "-o", out,
                     *(obj(out, s) for s in srcs)],
        compiles=lambda out: [[nvcc, *NVCC_FLAGS, "-c", "-o", obj(out, s), s]
                              for s in srcs])


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def kernels() -> ctypes.CDLL:
    """The loaded kernels library (built on the first call)."""
    lib = ctypes.CDLL(build_kernels())
    # every pointer and the stream as c_void_p: a bare Python int would be
    # passed as a 32-bit int and cut the address
    lib.tsp_window_ell_fold.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P,
        _P]
    lib.tsp_window_ell_fold.restype = _I
    # the epilogues and the table's set-up take one argument block (bytes
    # packed by the wrapper): one pointer converted per launch instead of
    # seven to thirteen values
    for fn in (lib.tsp_section_epilogue, lib.tsp_unpermute,
               lib.tsp_permute_chunks):
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = _I
    # K4 (csrc/merge_csr.cu)
    lib.tsp_merge_csr.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P,
                                  _P]
    lib.tsp_merge_csr.restype = _I
    lib.tsp_merge_csr_ctas.argtypes = [_I]
    lib.tsp_merge_csr_ctas.restype = _I
    # K5 (csrc/merge_csr.cu)
    lib.tsp_merge_spmm.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _P, _P, _P, _P]
    lib.tsp_merge_spmm.restype = _I
    lib.tsp_merge_spmm_warps.argtypes = []
    lib.tsp_merge_spmm_warps.restype = _I
    # the benchmark probes (tpu_spmv_torch/probes)
    lib.tsp_probe_proto_v2.argtypes = [
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P]
    lib.tsp_probe_profile_kernel.argtypes = [
        _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P]
    lib.tsp_probe_proto_v3.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P]
    lib.tsp_probe_proto_v4.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P,
        _P]
    lib.tsp_probe_dma_share.argtypes = [
        _P, _P, _P, _I, _I, _I, _I, _P, _P, _P]
    for fn in (lib.tsp_probe_proto_v2, lib.tsp_probe_profile_kernel,
               lib.tsp_probe_proto_v3,
               lib.tsp_probe_proto_v4, lib.tsp_probe_dma_share):
        fn.restype = _I
    return lib
