"""The reference spec's two efficiency properties (port of
``benchmarks/perf_properties.py``).

    python3 -m tpu_spmv_torch.benchmarks.perf_properties [--rows N]
        [--cols N] [--avg K] [--device cpu] [--out FILE]

* Vector-CSR row-length robustness: Gnnz/s on a matrix of varying row
  lengths at least 80% of the same-size uniform-row matrix's
  (``requirements.md:66``).
* Merge-path skew robustness: Gnnz/s on a power-law matrix of skew over
  100 at least 70% of the uniform matrix's (``requirements.md:68``).

Each matrix is served by the plan the dispatch resolves for it
(``spmv._resolve_csr_kernel``), checked against the CPU oracle at rel 1e-5
(a failure ends the run) and timed under the physics guard against STREAM
(the JAX script's floor of 4 B a nonzero at the v5e's HBM rate does not
apply to the card).  One JSON object on stdout, the JAX script's keys,
``device`` and ``correct``; the exit code is 1 where a property is
missed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..bench import Clock, check, log
from ..csr import CSRMatrix
from ..errors import guarded_upload, target_device
from ..spmv import KernelType, SpMVConfig, _resolve_csr_kernel, _run
from ..utils.testing import RandomGenerator
from . import checked_seconds

ITERS = 300
REL_TOL = 1e-5
VECTOR_TARGET = 0.80
MERGE_TARGET = 0.70
SKEW_MIN = 100
SKEW_ALPHA = 1.2


def _uniform_csr(rng: RandomGenerator, rows: int, cols: int,
                 nnz_per_row: int) -> CSRMatrix:
    """Every row exactly ``nnz_per_row`` sorted distinct columns: a random
    start and a random odd stride a row (coprime to the power-of-two
    ``cols``), the JAX script's draws."""
    r = rng.rng
    start = r.integers(0, cols, (rows, 1))
    stride = r.integers(0, cols // 2, (rows, 1)) * 2 + 1
    k = np.arange(nnz_per_row, dtype=np.int64)[None, :]
    cols_arr = np.sort(((start + stride * k) % cols).astype(np.int32),
                       axis=1)
    row_ptrs = (np.arange(rows + 1, dtype=np.int64)
                * nnz_per_row).astype(np.int32)
    vals = r.uniform(-10, 10, rows * nnz_per_row).astype(np.float32)
    vals[vals == 0.0] = 1.0
    return CSRMatrix(rows, cols, vals, cols_arr.reshape(-1), row_ptrs)


def _varying_csr(rng: RandomGenerator, rows: int, cols: int,
                 avg: int) -> CSRMatrix:
    """Row lengths uniform on [1, 2·avg - 1] (varying, not skewed), random
    sorted columns, duplicates kept (they add), the JAX script's draws."""
    r = rng.rng
    lens = r.integers(1, 2 * avg, rows).astype(np.int64)
    row_ptrs = np.zeros(rows + 1, np.int32)
    np.cumsum(lens, out=row_ptrs[1:])
    nnz = int(row_ptrs[-1])
    cols_arr = r.integers(0, cols, nnz).astype(np.int32)
    order = np.argsort(np.repeat(np.arange(rows), lens) * np.int64(cols)
                       + cols_arr, kind="stable")
    cols_arr = cols_arr[order]
    vals = r.uniform(-10, 10, nnz).astype(np.float32)
    vals[vals == 0.0] = 1.0
    return CSRMatrix(rows, cols, vals, cols_arr, row_ptrs)


def _measure_gnnz(csr: CSRMatrix, kernel_type: KernelType,
                  rng: RandomGenerator, clock: Clock,
                  iters: int = ITERS) -> tuple:
    """``(Gnnz/s, seconds a call)`` of the plan the dispatch resolves for
    ``csr``, after the oracle check (:class:`~tpu_spmv_torch.bench.
    BenchFailure` where it fails), timed under the guard."""
    plan = _resolve_csr_kernel(csr, kernel_type,
                               SpMVConfig(kernel_type=kernel_type),
                               clock.device)
    x = rng.vector(csr.num_cols)
    xd = guarded_upload(x, clock.device)
    secs = checked_seconds(f"{kernel_type.name} ({type(plan).__name__})",
                           lambda: _run(plan, xd), csr, x, plan.stream_bytes,
                           clock, iters, REL_TOL)
    return csr.nnz / secs / 1e9, secs


def vector_csr_property(uni: CSRMatrix, var: CSRMatrix,
                        rng: RandomGenerator, clock: Clock,
                        iters: int = ITERS) -> dict:
    """Varying against uniform row lengths on the VECTOR_CSR route."""
    g_uni, t_uni = _measure_gnnz(uni, KernelType.VECTOR_CSR, rng, clock,
                                 iters)
    g_var, t_var = _measure_gnnz(var, KernelType.VECTOR_CSR, rng, clock,
                                 iters)
    ratio = g_var / g_uni if g_uni > 0 else 0.0
    log(f"vector-CSR: uniform {g_uni:.2f} Gnnz/s ({t_uni*1e6:.0f} us), "
        f"varying {g_var:.2f} Gnnz/s ({t_var*1e6:.0f} us) -> ratio "
        f"{ratio:.3f} (target >= {VECTOR_TARGET})")
    return {"vector_csr_varying_over_uniform": round(ratio, 4),
            "vector_csr_target": VECTOR_TARGET,
            "vector_csr_pass": bool(ratio >= VECTOR_TARGET),
            "uniform_gnnz_s": round(g_uni, 3),
            "varying_gnnz_s": round(g_var, 3)}


def merge_path_property(skew_m: CSRMatrix, uni: CSRMatrix,
                        rng: RandomGenerator, clock: Clock,
                        iters: int = ITERS) -> dict:
    """The skewed matrix against the uniform one on the MERGE_PATH
    route."""
    g_skew, t_skew = _measure_gnnz(skew_m, KernelType.MERGE_PATH, rng,
                                   clock, iters)
    g_uni, t_uni = _measure_gnnz(uni, KernelType.MERGE_PATH, rng, clock,
                                 iters)
    ratio = g_skew / g_uni if g_uni > 0 else 0.0
    log(f"merge-path: uniform {g_uni:.2f} Gnnz/s ({t_uni*1e6:.0f} us), "
        f"skew {g_skew:.2f} Gnnz/s ({t_skew*1e6:.0f} us) -> ratio "
        f"{ratio:.3f} (target >= {MERGE_TARGET})")
    return {"merge_path_skew_over_uniform": round(ratio, 4),
            "merge_path_target": MERGE_TARGET,
            "merge_path_pass": bool(ratio >= MERGE_TARGET),
            "uniform_mp_gnnz_s": round(g_uni, 3),
            "skew_gnnz_s": round(g_skew, 3)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpu_spmv_torch.benchmarks.perf_properties")
    p.add_argument("--rows", type=int, default=131072)
    p.add_argument("--cols", type=int, default=4096)
    p.add_argument("--avg", type=int, default=32)
    p.add_argument("--device", default="cuda",
                   help="where to run: the card (default), or cpu")
    p.add_argument("--out", default=None,
                   help="also write the JSON to this file")
    args = p.parse_args(argv)
    clock = Clock.on(target_device(args.device, "perf_properties"))
    t0 = time.time()
    log(f"device: {clock.name}")
    rng = RandomGenerator(42)
    uni = _uniform_csr(rng, args.rows, args.cols, args.avg)
    var = _varying_csr(rng, args.rows, args.cols, args.avg)
    log(f"vector-CSR: uniform nnz={uni.nnz}, varying nnz={var.nnz}")
    vec = vector_csr_property(uni, var, rng, clock)
    skew_m = rng.power_law_csr(args.rows, args.cols, avg_nnz=float(args.avg),
                               alpha=SKEW_ALPHA)
    skew = skew_m.compute_stats().skewness
    log(f"merge-path: skew matrix nnz={skew_m.nnz} skew={skew:.0f} "
        f"(need > {SKEW_MIN})")
    check(skew > SKEW_MIN, "the generator did not reach the skew regime")
    mp = merge_path_property(skew_m, uni, rng, clock)
    report = {
        "artifact": "perf_properties", "device": clock.name,
        "rows": args.rows, "cols": args.cols, "avg_nnz": args.avg,
        **{k: v for k, v in vec.items() if k.startswith("vector")},
        **{k: v for k, v in mp.items() if k.startswith("merge")},
        "correct": True,
        "detail": {"uniform_gnnz_s": vec["uniform_gnnz_s"],
                   "varying_gnnz_s": vec["varying_gnnz_s"],
                   "uniform_mp_gnnz_s": mp["uniform_mp_gnnz_s"],
                   "skew_gnnz_s": mp["skew_gnnz_s"],
                   "skewness": round(skew, 1),
                   "total_s": round(time.time() - t0, 1)},
    }
    print(json.dumps(report), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0 if report["vector_csr_pass"] and report["merge_path_pass"] \
        else 1


if __name__ == "__main__":
    sys.exit(main())
