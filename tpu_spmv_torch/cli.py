"""The benchmark demo on an NVIDIA GPU (port of ``tpu_spmv/cli.py``, the
reference's ``benchmarks/main.cu``).

    python -m tpu_spmv_torch.cli [--json] [--matrix FILE.mtx] ...
    tpu-spmv-torch-benchmark ...            (the installed console script)

The device banner (``main.cu:151-156``: the card's name, its
``nvidia-smi`` name and power limit, the device-attribute peak), the
three-kernel sweep on a random 1000 x 1000 matrix of density 0.05, seed 42
(``main.cu:16-80``) through :func:`~tpu_spmv_torch.benchmark.benchmark_csr`,
the auto-selector's pick, the GPU against the CPU (``main.cu:73-77``), and
PageRank on 100 nodes with its top 10 (``main.cu:82-144``).  ``--json``
prints the results in the reference's JSON; ``--matrix`` reads a Matrix
Market file instead of the random matrix.

It runs on the card.  ``--device cpu`` runs it on the CPU, the kernels'
plain versions serving; without a card and without that flag it exits
with code 2 and a message, and never carries on on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

from .benchmark import (BenchmarkConfig, benchmark_csr, benchmark_to_json,
                        compare_gpu_cpu_csr, comparison_to_json)
from .csr import csr_from_dense
from .pagerank import PageRankConfig, pagerank, pagerank_top_k
from .selector import spmv_auto_config
from .spmv import KernelType, SpMVConfig
from .utils.testing import RandomGenerator


def print_device_info(device: torch.device) -> None:
    print("=" * 60)
    print("Device Information")
    print("=" * 60)
    if device.type != "cuda":
        print(f"  Device:        {device} (named by the caller)")
        print()
        return
    from .bandwidth import get_gpu_peak_bandwidth

    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip() or "not available"
    except (OSError, subprocess.SubprocessError):
        smi = "not available"
    print(f"  Device:        {torch.cuda.get_device_name(index)}")
    print(f"  nvidia-smi:    {smi}")
    print(f"  Peak DRAM BW:  {get_gpu_peak_bandwidth(index):.0f} GB/s "
          f"(device attributes)")
    print()


def benchmark_spmv(rows: int, cols: int, density: float, runs: int,
                   emit_json: bool, device: torch.device,
                   matrix: str | None = None, pattern: bool = False,
                   permute_rows: bool = False) -> None:
    """The reference's three-kernel sweep (``main.cu:16-80``); ``matrix``
    reads a Matrix Market file instead of the random matrix, ``pattern``
    and ``permute_rows`` set the packed plans' levers."""
    if permute_rows:
        os.environ["TPU_SPMV_PERMUTE_ROWS"] = "1"
    rng = RandomGenerator(42)
    if matrix:
        from .io.matrix_market import load_matrix_market

        csr = load_matrix_market(matrix)
        rows, cols = csr.num_rows, csr.num_cols
        density = csr.nnz / max(rows * cols, 1)
        src = matrix
    else:
        csr = csr_from_dense(rng.dense_matrix(rows, cols, density))
        src = "generated"
    x = rng.vector(cols)
    bc = BenchmarkConfig(num_runs=runs)

    print(f"SpMV sweep: {rows}x{cols} ({src}), density {density:.4g}, "
          f"nnz {csr.nnz}")
    print("-" * 60)
    results = {}
    for kt in (KernelType.SCALAR_CSR, KernelType.VECTOR_CSR,
               KernelType.MERGE_PATH):
        r = benchmark_csr(csr, x, SpMVConfig(kernel_type=kt,
                                             pattern=pattern), bc,
                          name=kt.name.lower(), device=device)
        results[kt.name] = r
        print(f"  {kt.name:12s}: avg {r.avg_time_ms:9.4f} ms  "
              f"{r.gflops:8.2f} GFLOP/s  {r.bandwidth_gb_s:8.2f} GB/s  "
              f"correct={r.correct}")
    auto = spmv_auto_config(csr)
    print(f"  auto-selector picks: {KernelType(auto.kernel_type).name}")
    comp = compare_gpu_cpu_csr(csr, x,
                               SpMVConfig(kernel_type=auto.kernel_type), bc,
                               device=device)
    print(f"  GPU vs CPU speedup: {comp.speedup:.2f}x")
    if emit_json:
        print(comparison_to_json(comp))
        for r in results.values():
            print(benchmark_to_json(r))
    print()


def benchmark_pagerank(n: int, emit_json: bool,
                       device: torch.device) -> None:
    """The PageRank demo (``main.cu:82-144``): a random 5% graph without
    self-loops, column-normalised."""
    rng = RandomGenerator(42)
    adj = (rng.rng.random((n, n)) < 0.05).astype(np.float32)
    np.fill_diagonal(adj, 0.0)
    col_sums = adj.sum(axis=0)          # main.cu:102-112
    nz = col_sums > 0
    adj[:, nz] /= col_sums[nz]
    csr = csr_from_dense(adj)
    res = pagerank(csr, PageRankConfig(), device=device)
    if res.error_code:
        raise RuntimeError(f"pagerank failed: error {res.error_code}")
    print(f"PageRank: {n} nodes, {csr.nnz} edges")
    print(f"  iterations: {res.iterations}, converged: {res.converged}, "
          f"residual: {res.final_residual:.2e}")
    top = pagerank_top_k(res, n, 10)
    print("  top-10 nodes:")
    for t in top:
        print(f"    node {t.node_id:6d}: {t.rank:.6f}")
    if emit_json:
        print(json.dumps({
            "iterations": res.iterations,
            "converged": res.converged,
            "final_residual": res.final_residual,
            "top_k": [{"node_id": t.node_id, "rank": t.rank} for t in top],
        }, indent=2))
    print()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="tpu_spmv_torch benchmark demo (runs on the GPU)")
    p.add_argument("--rows", type=int, default=1000)
    p.add_argument("--cols", type=int, default=1000)
    p.add_argument("--density", type=float, default=0.05)
    p.add_argument("--runs", type=int, default=20)
    p.add_argument("--pagerank-nodes", type=int, default=100)
    p.add_argument("--json", action="store_true", help="emit JSON results")
    p.add_argument("--skip-pagerank", action="store_true")
    p.add_argument("--matrix", type=str, default=None, metavar="FILE.mtx",
                   help="benchmark a Matrix Market file instead of a "
                        "generated matrix")
    p.add_argument("--pattern", action="store_true",
                   help="route column-scaled matrices through pattern "
                        "plans (no value stream)")
    p.add_argument("--permute-rows", action="store_true",
                   help="level rows onto lanes within each superblock of "
                        "the packed plans")
    p.add_argument("--device", type=str, default=None,
                   help="run on this device instead of the card (cpu: "
                        "the kernels' plain versions)")
    args = p.parse_args(argv)

    device = torch.device(args.device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        print("tpu_spmv_torch.cli: no CUDA device is available; the demo "
              "runs on an NVIDIA GPU (--device cpu runs it on the CPU)",
              file=sys.stderr)
        return 2
    print_device_info(device)
    benchmark_spmv(args.rows, args.cols, args.density, args.runs, args.json,
                   device, matrix=args.matrix, pattern=args.pattern,
                   permute_rows=args.permute_rows)
    if not args.skip_pagerank:
        benchmark_pagerank(args.pagerank_nodes, args.json, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
