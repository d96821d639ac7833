"""Bandwidth metrics (port of ``tpu_spmv/bandwidth.py``).

* The CSR byte model is the reference's (``bandwidth.cpp:34-42``): read
  ``nnz*(4+4) + (rows+1)*4 + cols*4``, write ``rows*4``; the ELL one
  (``bandwidth.cpp:66-75``) reads ``rows*max_nnz*(4+4) + cols*4`` and
  writes ``rows*4``.
* The peak comes from the device's own attributes, memory clock × bus width
  × 2, as the CUDA reference's ``get_gpu_peak_bandwidth`` computes it
  (``bandwidth.cpp:7-20``), read with ``cudaDeviceGetAttribute`` through
  ctypes on the CUDA runtime, unless ``TPU_SPMV_PEAK_GBS`` names it.
* STREAM is measured on the device with the JAX package's 256 MB
  read-reduce (``bandwidth.py:80-100``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os

import torch

# cudaDeviceAttr values (driver_types.h)
_ATTR_MEMORY_CLOCK_RATE = 36      # kHz
_ATTR_GLOBAL_MEMORY_BUS_WIDTH = 37  # bits


@dataclasses.dataclass
class BandwidthMetrics:
    """Reference ``BandwidthMetrics`` (``bandwidth.h:10-18``)."""

    theoretical_gb_s: float
    achieved_gb_s: float
    efficiency: float  # achieved / theoretical, clamped to [0, 1]


def _cudart() -> ctypes.CDLL:
    """The CUDA runtime library: the one this process already mapped
    (PyTorch loads it), else the toolkit's."""
    with open("/proc/self/maps") as maps:
        for line in maps:
            path = line.split()[-1]
            if "libcudart" in os.path.basename(path):
                return ctypes.CDLL(path)
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for name in ("libcudart.so.13", "libcudart.so.12", "libcudart.so",
                 os.path.join(home, "lib64", "libcudart.so")):
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    raise RuntimeError("CUDA runtime library (libcudart) not found")


def get_gpu_peak_bandwidth(device: int = 0) -> float:
    """Theoretical peak device-memory bandwidth in GB/s: the
    ``TPU_SPMV_PEAK_GBS`` override where it is set (as the JAX package
    reads it first), else memory clock (kHz) × 1e3 × bus width (bits) / 8 ×
    2 (double data rate) / 1e9 from the device's attributes."""
    env = os.environ.get("TPU_SPMV_PEAK_GBS")
    if env:
        return float(env)
    torch.cuda.init()
    lib = _cudart()
    fn = lib.cudaDeviceGetAttribute
    fn.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    clock_khz, bus_bits = ctypes.c_int(0), ctypes.c_int(0)
    for attr, out in ((_ATTR_MEMORY_CLOCK_RATE, clock_khz),
                      (_ATTR_GLOBAL_MEMORY_BUS_WIDTH, bus_bits)):
        err = fn(ctypes.byref(out), attr, device)
        if err:
            raise RuntimeError(f"cudaDeviceGetAttribute({attr}): error {err}")
    return 2.0 * clock_khz.value * 1e3 * (bus_bits.value / 8) / 1e9


def measured_stream_bandwidth(device=None) -> float:
    """Measured read bandwidth (GB/s): one fused read-reduce over 256 MB,
    timed with CUDA events — the denominator of the physics guard."""
    from .timing import time_cuda

    n = 1 << 26  # 256 MB of f32
    x = torch.arange(n, dtype=torch.float32, device=device or "cuda")
    secs = time_cuda(lambda: torch.sum(x), iters=20, samples=5, warmup=3)
    return n * 4 / secs / 1e9


def _csr_bytes(num_rows: int, num_cols: int, nnz: int) -> int:
    """CSR byte model (``bandwidth.cpp:34-42``)."""
    read = nnz * (4 + 4) + (num_rows + 1) * 4 + num_cols * 4
    write = num_rows * 4
    return read + write


def compute_bandwidth_csr(num_rows: int, num_cols: int, nnz: int,
                          elapsed_ms: float,
                          peak_gb_s: float) -> BandwidthMetrics:
    """Reference ``compute_bandwidth_csr`` (``bandwidth.cpp:22-56``), with
    the peak passed in (see :func:`get_gpu_peak_bandwidth`)."""
    if elapsed_ms <= 0.0:
        return BandwidthMetrics(peak_gb_s, 0.0, 0.0)
    achieved = _csr_bytes(num_rows, num_cols, nnz) / (elapsed_ms * 1e-3) / 1e9
    eff = min(achieved / peak_gb_s, 1.0) if peak_gb_s > 0 else 0.0
    return BandwidthMetrics(peak_gb_s, achieved, eff)


def _ell_bytes(num_rows: int, num_cols: int, max_nnz_per_row: int) -> int:
    """ELL byte model (``bandwidth.cpp:66-75``)."""
    read = num_rows * max_nnz_per_row * (4 + 4) + num_cols * 4
    write = num_rows * 4
    return read + write


def compute_bandwidth_ell(num_rows: int, num_cols: int, max_nnz_per_row: int,
                          elapsed_ms: float,
                          peak_gb_s: float) -> BandwidthMetrics:
    """Reference ``compute_bandwidth_ell`` (``bandwidth.cpp:58-88``), with
    the peak passed in (see :func:`get_gpu_peak_bandwidth`)."""
    if elapsed_ms <= 0.0:
        return BandwidthMetrics(peak_gb_s, 0.0, 0.0)
    achieved = _ell_bytes(num_rows, num_cols, max_nnz_per_row) \
        / (elapsed_ms * 1e-3) / 1e9
    eff = min(achieved / peak_gb_s, 1.0) if peak_gb_s > 0 else 0.0
    return BandwidthMetrics(peak_gb_s, achieved, eff)
