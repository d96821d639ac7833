"""The routes served where the single packed plan is not (port of
``benchmarks/fallback_bench.py``).

    python3 -m tpu_spmv_torch.benchmarks.fallback_bench [--device cpu]
        [--out FILE]

On ``RandomGenerator(42)``'s draws, in the JAX script's order:

1. the composite plan on the headline matrix (what a guard rejection of
   the single and banded planners serves);
1b. the naive SCALAR_CSR plan (no row splits, no spill) on a 65,536-row
   matrix of the headline's law;
2. column strips on 65,536 rows x 4M columns (past ``PACKED_MAX_COLS``);
2b. a 65,536 x 2M ELL matrix through the public ``spmv_ell``;
3. the flat path on the 4M-column matrix.

Each is held to the CPU oracle at rel 1e-5 (a failure ends the run
non-zero) and timed; ``build_s`` is the host planner's seconds and
``upload_s`` the plan's copy to the device, synchronised.  One JSON object
on stdout, the JAX script's keys and ``device``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..bench import Clock, log, model_bytes
from ..csr import CSRMatrix
from ..ell import ELLMatrix
from ..errors import guarded_upload, target_device
from ..kernels import upload
from ..kernels.plan import build, build_composite
from ..kernels.scalar import spmv_csr_scalar
from ..kernels.strips import build_strips_host
from ..spmv import run_plan, spmv_ell
from ..utils.testing import RandomGenerator, spmv_matches

REL_TOL = 1e-5
HEADLINE = (262144, 4096, 40.0, 1.6)
NAIVE_ROWS = 65536
WIDE = (65536, 1 << 22, 40)          # rows, columns, nonzeros a row
ELL_WIDE = (65536, 1 << 21, 16)
COMPOSITE_ITERS, ITERS, FLAT_ITERS = 200, 100, 3


def wide_csr(rng: RandomGenerator, rows: int, cols: int,
             k: int) -> CSRMatrix:
    """``k`` uniform random columns a row (``fallback_bench.py:132-138``)."""
    base_r = np.repeat(np.arange(rows, dtype=np.int64), k)
    cc = rng.rng.integers(0, cols, size=len(base_r))
    order = np.lexsort((cc, base_r))
    rp = np.arange(rows + 1, dtype=np.int32) * k
    return CSRMatrix(rows, cols, rng.vector(rows * k).astype(np.float32),
                     cc[order].astype(np.int32), rp)


def wide_ell(rng: RandomGenerator, rows: int, cols: int,
             k: int) -> ELLMatrix:
    """One column draw per stride of ``cols / k``: sorted rows without
    duplicates (``fallback_bench.py:161-168``)."""
    stride = cols // k
    ecc = (np.arange(k, dtype=np.int64) * stride
           + rng.rng.integers(0, stride, size=(rows, k))).astype(np.int32)
    evv = rng.vector(rows * k).astype(np.float32).reshape(rows, k)
    return ELLMatrix(rows, cols, k, evv.T.ravel(), ecc.T.ravel())


def timed_upload(host, device: torch.device) -> tuple:
    """``(device plan, seconds)``: the copy, synchronised on the card."""
    t0 = time.perf_counter()
    plan = upload(host, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return plan, time.perf_counter() - t0


def composite_plan(A: CSRMatrix):
    """What a guard rejection of the single and banded plans serves."""
    return build_composite(A, split_rows=128)


def naive_plan(A: CSRMatrix):
    """SCALAR_CSR's naive layout: no row splits, no spill."""
    return build(A, split_rows=None, spill_beta=0.0, cap_margin=1e9)


def packed_row(A: CSRMatrix, x: np.ndarray, make, clock: Clock,
               iters: int) -> tuple:
    """Build a host plan (``make(A)``), upload it, check it against the
    oracle and time it.  Returns ``(row dict, host plan, seconds a
    call)``."""
    t0 = time.perf_counter()
    host = make(A)
    build_s = time.perf_counter() - t0
    plan, up_s = timed_upload(host, clock.device)
    xd = guarded_upload(x, clock.device)
    ok = spmv_matches(run_plan(plan, xd).cpu().numpy(), A, x,
                      rel_tol=REL_TOL)
    s = clock.seconds(lambda: run_plan(plan, xd), iters)
    row = {"correct": bool(ok), "t_us": s * 1e6,
           "gb_s": model_bytes(A.num_rows, A.num_cols, A.nnz) / s / 1e9,
           "build_s": build_s, "upload_s": up_s}
    return row, host, s


def composite_headline(A, x, clock: Clock,
                       iters: int = COMPOSITE_ITERS) -> dict:
    row, host, _ = packed_row(A, x, composite_plan, clock, iters)
    return {"levels": len(host.plans), "tail": host.tail is not None, **row}


def naive_scalar(A, x, clock: Clock, iters: int = ITERS) -> dict:
    row, host, _ = packed_row(A, x, naive_plan, clock, iters)
    return {"groups": int(host.n_groups),
            "occupancy": float(host.occupancy), **row}


def strips(A, x, clock: Clock, iters: int = ITERS) -> tuple:
    """The strips' row and their seconds a call."""
    row, host, s = packed_row(A, x, build_strips_host, clock, iters)
    return {"strips": len(host.plans), "nnz": A.nnz, **row}, s


def ell_wide(E: ELLMatrix, x: np.ndarray, clock: Clock,
             iters: int = ITERS) -> dict:
    """The public ``spmv_ell`` (the wide ELL route: column strips of its
    CSR form), measured on the card, its served plan timed on the CPU."""
    cuda = clock.device.type == "cuda"
    t0 = time.perf_counter()
    r = spmv_ell(E, x, measure=cuda, device=clock.device)
    e2e = time.perf_counter() - t0
    A = E.to_csr()
    ok = r.error_code == 0 and spmv_matches(r.y_host(), A, x,
                                            rel_tol=REL_TOL)
    if cuda:
        s = r.elapsed_ms / 1e3
    else:
        xd = guarded_upload(x, clock.device)
        s = clock.seconds(lambda: run_plan(r.plan, xd), iters)
    return {"nnz": int(A.nnz), "correct": bool(ok), "t_us": s * 1e6,
            "gb_s": model_bytes(E.num_rows, E.num_cols, A.nnz) / s / 1e9,
            "e2e_s": e2e, "error_code": int(r.error_code)}


def flat(A: CSRMatrix, x: np.ndarray, clock: Clock,
         s_strips: float) -> dict:
    dcsr = A.to_device(clock.device)
    xd = guarded_upload(x, clock.device)
    ok = spmv_matches(spmv_csr_scalar(dcsr, xd).cpu().numpy(), A, x,
                      rel_tol=REL_TOL)
    s = clock.seconds(lambda: spmv_csr_scalar(dcsr, xd), FLAT_ITERS)
    return {"correct": bool(ok), "t_us": s * 1e6,
            "gb_s": model_bytes(A.num_rows, A.num_cols, A.nnz) / s / 1e9,
            "speedup_strips_vs_flat": s / s_strips}


def run(clock: Clock) -> dict:
    rng = RandomGenerator(42)
    out = {"device": clock.name}
    rows, cols, avg, alpha = HEADLINE
    A = rng.power_law_csr(rows, cols, avg_nnz=avg, alpha=alpha)
    out["composite_headline"] = composite_headline(A, rng.vector(cols),
                                                   clock)
    log(f"composite headline: {out['composite_headline']}")
    del A
    small = rng.power_law_csr(NAIVE_ROWS, cols, avg_nnz=avg, alpha=alpha)
    out["naive_scalar_64k"] = naive_scalar(small, rng.vector(cols), clock)
    log(f"naive scalar 64K: {out['naive_scalar_64k']}")
    wide = wide_csr(rng, *WIDE)
    xw = rng.vector(WIDE[1])
    out["strips_4m_cols"], s_strips = strips(wide, xw, clock)
    log(f"strips 4M cols: {out['strips_4m_cols']}")
    E = wide_ell(rng, *ELL_WIDE)
    out["ell_wide_2m_cols"] = ell_wide(E, rng.vector(ELL_WIDE[1]), clock)
    log(f"wide ELL 2M cols (public dispatch): {out['ell_wide_2m_cols']}")
    del E
    out["flat_4m_cols"] = flat(wide, xw, clock, s_strips)
    log(f"flat 4M cols: {out['flat_4m_cols']}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpu_spmv_torch.benchmarks.fallback_bench")
    p.add_argument("--device", default="cuda",
                   help="where to run: the card (default), or cpu")
    p.add_argument("--out", default=None,
                   help="also write the JSON to this file")
    args = p.parse_args(argv)
    out = run(Clock.on(target_device(args.device, "fallback_bench")))
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    if not all(v["correct"] for v in out.values() if isinstance(v, dict)):
        log("fallback_bench: a route failed the oracle")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
