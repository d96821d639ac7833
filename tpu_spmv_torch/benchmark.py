"""Benchmark harness (port of ``tpu_spmv/benchmark.py``).

The reference harness (``include/spmv/benchmark.h``, ``src/benchmark.cu``):
warm-up runs, then timed runs; average, minimum, maximum and the sample
standard deviation (n−1, ``benchmark.cu:10-19``) of the time per call; a
device-against-CPU comparison with ``speedup = cpu_avg / device_avg``
(``benchmark.cu:180-182``); and JSON with the reference's field names
(``benchmark.cu:187-237``), the device key ``"gpu"`` as the CUDA reference
writes it (the JAX package wrote ``"tpu"``).

:func:`benchmark_csr` and :func:`benchmark_ell` time exactly the plan that
:func:`~tpu_spmv_torch.spmv.spmv_csr` / :func:`~tpu_spmv_torch.spmv.spmv_ell`
resolve, on the card unless the caller names another device: each run over
CUDA events (:func:`~tpu_spmv_torch.timing.time_runs`), the host clock only
on a CPU device the caller names.  Each result carries ``correct`` (the
timed plan's output against the CPU oracle) and ``plan_build_ms`` (the
plan's resolution: build and upload, or a cache hit).
"""

from __future__ import annotations

import dataclasses
import json
import math
import time

import numpy as np
import torch

from .bandwidth import compute_bandwidth_csr, compute_bandwidth_ell
from .csr import CSRMatrix
from .ell import ELLMatrix
from .errors import guarded_upload, target_device
from .ops import spmv_cpu_csr
from .spmv import (KernelType, SpMVConfig, ell_csr, resolve_csr, resolve_ell,
                   run_plan)
from .timing import time_runs
from .utils.testing import spmv_matches

# the row bound of ``correct``: |Δy|_i <= tol * max((|A||x|)_i, 1), at the
# f32 tolerance, or at a bf16 value stream's rounding
CORRECT_REL_TOL = 1e-5
CORRECT_REL_TOL_BF16 = 8e-3


@dataclasses.dataclass
class BenchmarkConfig:
    """Reference ``BenchmarkConfig`` (``benchmark.h:34-40``) plus the calls
    per timed run."""

    num_warmup_runs: int = 5
    num_runs: int = 20
    compare_cpu: bool = True
    iters_per_run: int | None = None   # None: calibrated to ~50 ms a run


@dataclasses.dataclass
class BenchmarkResult:
    """Reference ``BenchmarkResult`` (``benchmark.h:13-31``) with the JAX
    package's two fields: ``correct`` and ``plan_build_ms``."""

    name: str = ""
    execution_time_ms: float = 0.0   # the last run
    gflops: float = 0.0
    bandwidth_gb_s: float = 0.0
    avg_time_ms: float = 0.0
    min_time_ms: float = 0.0
    max_time_ms: float = 0.0
    stddev_time_ms: float = 0.0
    num_runs: int = 0
    correct: bool = True
    plan_build_ms: float = 0.0


@dataclasses.dataclass
class ComparisonResult:
    """Reference ``ComparisonResult`` (``benchmark.h:24-31``)."""

    device_result: BenchmarkResult = dataclasses.field(
        default_factory=BenchmarkResult)
    cpu_result: BenchmarkResult = dataclasses.field(
        default_factory=BenchmarkResult)
    speedup: float = 0.0


def compute_stddev(times_ms: list, avg: float) -> float:
    """Sample standard deviation, n−1 divisor (``benchmark.cu:10-19``)."""
    if len(times_ms) < 2:
        return 0.0
    var = sum((t - avg) ** 2 for t in times_ms) / (len(times_ms) - 1)
    return math.sqrt(var)


def _stats(name: str, times_ms: list, nnz: int,
           bandwidth_fn) -> BenchmarkResult:
    r = BenchmarkResult(name=name, num_runs=len(times_ms))
    if not times_ms:
        return r
    r.execution_time_ms = times_ms[-1]
    r.avg_time_ms = sum(times_ms) / len(times_ms)
    r.min_time_ms = min(times_ms)
    r.max_time_ms = max(times_ms)
    r.stddev_time_ms = compute_stddev(times_ms, r.avg_time_ms)
    if r.avg_time_ms > 0:
        r.gflops = 2.0 * nnz / (r.avg_time_ms * 1e-3) / 1e9
        r.bandwidth_gb_s = bandwidth_fn(r.avg_time_ms).achieved_gb_s
    return r


def _peak(device: torch.device) -> float:
    """The device-attribute peak (GB/s) on a CUDA device; 0 on the CPU,
    which has none (the efficiency then reads 0)."""
    if device.type != "cuda":
        return 0.0
    from .bandwidth import get_gpu_peak_bandwidth

    return get_gpu_peak_bandwidth(device.index if device.index is not None
                                  else torch.cuda.current_device())


def _time(name: str, plan, x, csr: CSRMatrix, tol: float, device,
          bc: BenchmarkConfig, plan_ms: float, nnz: int,
          bandwidth_fn) -> BenchmarkResult:
    """Check the plan's output once against the oracle, then time it.

    ``correct`` is the row bound ``|Δy|_i <= tol·max((|A||x|)_i, 1)``
    (:func:`~tpu_spmv_torch.utils.testing.spmv_matches`), not the JAX
    harness's ``allclose(rtol=1e-4, atol=1e-5)``: that check reports false
    on a row whose terms cancel, whatever order the fp32 adds take, since
    the rounding of the terms is not small against the row's sum."""
    x_host = np.asarray(x, np.float32)
    xd = guarded_upload(x_host, device)
    y = run_plan(plan, xd).cpu().numpy()
    correct = bool(np.all(np.isfinite(y))
                   and spmv_matches(y, csr, x_host, rel_tol=tol))
    times = time_runs(lambda: run_plan(plan, xd), device,
                      num_runs=bc.num_runs, iters_per_run=bc.iters_per_run,
                      warmup_runs=1 if bc.num_warmup_runs else 0)
    r = _stats(name, [t * 1e3 for t in times], nnz, bandwidth_fn)
    r.correct = correct
    r.plan_build_ms = plan_ms
    return r


def benchmark_csr(A: CSRMatrix, x, config: SpMVConfig | None = None,
                  bench_config: BenchmarkConfig | None = None,
                  name: str = "csr_spmv", device=None) -> BenchmarkResult:
    """The warm-up and timed protocol over the plan ``spmv_csr`` serves
    (reference ``benchmark_csr``, ``benchmark.cu:21-75``), on the card
    unless the caller names another device."""
    device = target_device(device, "benchmark")
    bc = bench_config or BenchmarkConfig()
    cfg = config or SpMVConfig()
    t0 = time.perf_counter()
    plan = resolve_csr(A, KernelType(cfg.kernel_type), cfg, device)
    plan_ms = (time.perf_counter() - t0) * 1e3
    tol = CORRECT_REL_TOL_BF16 if cfg.bf16_values else CORRECT_REL_TOL
    peak = _peak(device)
    return _time(name, plan, x, A, tol, device, bc, plan_ms, A.nnz,
                 lambda ms: compute_bandwidth_csr(A.num_rows, A.num_cols,
                                                  A.nnz, ms, peak))


def benchmark_ell(A: ELLMatrix, x, config: SpMVConfig | None = None,
                  bench_config: BenchmarkConfig | None = None,
                  name: str = "ell_spmv", device=None) -> BenchmarkResult:
    """Reference ``benchmark_ell`` (``benchmark.cu:77-126``) over the plan
    ``spmv_ell`` serves, on the card unless the caller names another
    device.  The oracle is the CPU SpMV of ``A``'s CSR form, whose rows add
    in slot order, as :func:`~tpu_spmv_torch.ops.spmv_cpu_ell` does."""
    device = target_device(device, "benchmark")
    bc = bench_config or BenchmarkConfig()
    t0 = time.perf_counter()
    plan = resolve_ell(A, config, device)
    plan_ms = (time.perf_counter() - t0) * 1e3
    nnz, peak = A.nnz, _peak(device)
    return _time(name, plan, x, ell_csr(A), CORRECT_REL_TOL, device, bc,
                 plan_ms, nnz,
                 lambda ms: compute_bandwidth_ell(A.num_rows, A.num_cols,
                                                  A.max_nnz_per_row, ms,
                                                  peak))


def compare_gpu_cpu_csr(A: CSRMatrix, x, config: SpMVConfig | None = None,
                        bench_config: BenchmarkConfig | None = None,
                        device=None) -> ComparisonResult:
    """The device against the CPU oracle (reference
    ``compare_gpu_cpu_csr``, ``benchmark.cu:128-185``; the JAX
    ``compare_tpu_cpu_csr``); the CPU runs timed on the host clock."""
    bc = bench_config or BenchmarkConfig()
    comp = ComparisonResult()
    comp.device_result = benchmark_csr(A, x, config, bc, name="gpu_csr",
                                       device=device)
    x_host = np.asarray(x, np.float32)
    y_host = np.zeros(A.num_rows, np.float32)
    spmv_cpu_csr(A, x_host, y_host)   # warm-up
    cpu_times = []
    for _ in range(bc.num_runs):
        t0 = time.perf_counter()
        spmv_cpu_csr(A, x_host, y_host)
        cpu_times.append((time.perf_counter() - t0) * 1e3)
    comp.cpu_result = _stats("cpu_csr", cpu_times, A.nnz,
                             lambda ms: compute_bandwidth_csr(
                                 A.num_rows, A.num_cols, A.nnz, ms, 0.0))
    if comp.device_result.avg_time_ms > 0:
        comp.speedup = comp.cpu_result.avg_time_ms \
            / comp.device_result.avg_time_ms
    return comp


# ---- JSON (the reference's field names, benchmark.cu:187-237) ----

def benchmark_to_json(result: BenchmarkResult) -> str:
    """Reference ``benchmark_to_json`` (``benchmark.cu:187-202``): the same
    keys, floats with 6 decimals, then ``correct`` and ``plan_build_ms``."""
    f = lambda v: f"{v:.6f}"  # noqa: E731
    return (
        "{\n"
        f'  "name": "{result.name}",\n'
        f'  "execution_time_ms": {f(result.execution_time_ms)},\n'
        f'  "gflops": {f(result.gflops)},\n'
        f'  "bandwidth_gb_s": {f(result.bandwidth_gb_s)},\n'
        f'  "avg_time_ms": {f(result.avg_time_ms)},\n'
        f'  "min_time_ms": {f(result.min_time_ms)},\n'
        f'  "max_time_ms": {f(result.max_time_ms)},\n'
        f'  "stddev_time_ms": {f(result.stddev_time_ms)},\n'
        f'  "num_runs": {result.num_runs},\n'
        f'  "correct": {"true" if result.correct else "false"},\n'
        f'  "plan_build_ms": {f(result.plan_build_ms)}\n'
        "}"
    )


def comparison_to_json(result: ComparisonResult) -> str:
    """Reference ``comparison_to_json`` (``benchmark.cu:204-213``), the
    device key ``"gpu"``."""
    return (
        "{\n"
        f'  "gpu": {benchmark_to_json(result.device_result)},\n'
        f'  "cpu": {benchmark_to_json(result.cpu_result)},\n'
        f'  "speedup": {result.speedup:.6f}\n'
        "}"
    )


def benchmark_from_json(text: str) -> BenchmarkResult:
    """Parse a result back (reference ``benchmark_from_json``,
    ``benchmark.cu:215-237``, with a real JSON parser)."""
    data = json.loads(text)
    return BenchmarkResult(
        name=data.get("name", ""),
        execution_time_ms=float(data.get("execution_time_ms", 0.0)),
        gflops=float(data.get("gflops", 0.0)),
        bandwidth_gb_s=float(data.get("bandwidth_gb_s", 0.0)),
        avg_time_ms=float(data.get("avg_time_ms", 0.0)),
        min_time_ms=float(data.get("min_time_ms", 0.0)),
        max_time_ms=float(data.get("max_time_ms", 0.0)),
        stddev_time_ms=float(data.get("stddev_time_ms", 0.0)),
        num_runs=int(data.get("num_runs", 0)),
        correct=bool(data.get("correct", True)),
        plan_build_ms=float(data.get("plan_build_ms", 0.0)))
