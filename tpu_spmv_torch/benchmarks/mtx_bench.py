"""Matrix Market files at benchmark scale (port of
``benchmarks/mtx_bench.py``).

    python3 -m tpu_spmv_torch.benchmarks.mtx_bench [--device cpu]
        [--out FILE]

Three structured matrices made from the seed (a road-like scrambled banded
one, an R-MAT graph of scale 18, a scrambled planted-community one) are
written as ``.mtx`` files into a temporary directory, read back through
``io.load_matrix_market`` (the round trip must be exact) and served by the
public dispatch with the auto configuration, checked against the CPU
oracle at rel 1e-5 (a failure ends the run) and the plan that served it
timed (100 calls, median of 5), the byte-model GB/s held to the physics
guard (three tries, then the run fails).  No file comes from outside the
repo.  One JSON object on stdout, a record a matrix, and ``device``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from ..bench import Clock, check, log, model_bytes
from ..csr import CSRMatrix
from ..errors import guarded_upload, target_device
from ..io import load_matrix_market, save_matrix_market
from ..selector import spmv_auto_config
from ..spmv import _run, spmv_csr
from ..utils.testing import (RandomGenerator, clustered_csr,
                             scrambled_banded_csr, spmv_matches)

ITERS = 100
REL_TOL = 1e-5


def rmat_csr(gen: np.random.Generator, scale: int = 18, avg_nnz: int = 16,
             a: float = 0.57, b: float = 0.19, c: float = 0.19) -> CSRMatrix:
    """A recursive-matrix (Graph500-style) graph: power-law, self-similar,
    not block-local; the JAX script's draws."""
    n = 1 << scale
    m = n * avg_nnz
    rows = np.zeros(m, np.int64)
    cols = np.zeros(m, np.int64)
    for lvl in range(scale):
        r = gen.random(m)
        bit_r = (r >= a + b).astype(np.int64)
        r2 = gen.random(m)
        pright = np.where(bit_r == 0, b / (a + b), (1 - (a + b + c)) /
                          max(1 - (a + b + c) + c, 1e-9))
        bit_c = (r2 < pright).astype(np.int64)
        rows |= bit_r << lvl
        cols |= bit_c << lvl
    key = np.unique(rows * n + cols)
    rr, cc = key // n, (key % n).astype(np.int32)
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rr, minlength=n), out=ptr[1:])
    vals = gen.uniform(0.1, 1.0, len(key)).astype(np.float32)
    return CSRMatrix(n, n, vals, cc, ptr)


def cases(rng: RandomGenerator) -> tuple:
    """The three matrices, in the JAX script's order of draws."""
    return (
        ("road-like (scrambled banded)", scrambled_banded_csr(
            rng, 262144, bandwidth=2048, avg_nnz=6.0)),
        ("rmat scale-18", rmat_csr(rng.rng, scale=18, avg_nnz=12)),
        ("planted-community (scrambled)", clustered_csr(
            rng, 262144, n_clusters=32, avg_nnz=14.0)),
    )


def round_trip(m0: CSRMatrix, path: str) -> tuple:
    """``(matrix read back, exact, write s, read s)``."""
    t0 = time.time()
    save_matrix_market(m0, path)
    t_w = time.time() - t0
    t0 = time.time()
    m = load_matrix_market(path)
    t_r = time.time() - t0
    same = (m.num_rows == m0.num_rows and m.nnz == m0.nnz
            and np.array_equal(m.row_ptrs, m0.row_ptrs)
            and np.array_equal(m.col_indices, m0.col_indices)
            and np.array_equal(m.values, m0.values))
    return m, same, t_w, t_r


def serve(m: CSRMatrix, x: np.ndarray, clock: Clock) -> dict:
    """``m`` through ``spmv_csr`` with its auto configuration, held to the
    oracle (:class:`~tpu_spmv_torch.bench.BenchFailure` where it fails),
    then the plan that served it timed, its byte-model GB/s under the
    guard (the JAX script's guard)."""
    r = spmv_csr(m, x, spmv_auto_config(m), device=clock.device)
    check(r.error_code == 0 and spmv_matches(r.y_host(), m, x,
                                             rel_tol=REL_TOL),
          f"error code {r.error_code}, or the oracle failed")
    bm = model_bytes(m.num_rows, m.num_cols, m.nnz)
    xd = guarded_upload(x, clock.device)
    secs = clock.guarded(lambda: _run(r.plan, xd), bm, ITERS, "mtx")
    reordered = any(k[0] == "_reorder" and v is not None
                    for k, v in m._plan_cache.items()
                    if isinstance(k, tuple))
    return {"t_ms": round(secs * 1e3, 4), "gb_s": round(bm / secs / 1e9, 2),
            "correct": True, "reorder_applied": bool(reordered),
            "plan": type(r.plan).__name__}


def run(clock: Clock) -> dict:
    rng = RandomGenerator(42)
    out = {"device": clock.name}
    with tempfile.TemporaryDirectory() as d:
        for name, m0 in cases(rng):
            m, same, t_w, t_r = round_trip(m0, os.path.join(d, "m.mtx"))
            log(f"[{name}] mtx write {t_w:.1f}s read {t_r:.1f}s "
                f"roundtrip={same} nnz={m.nnz}")
            t0 = time.time()
            rec = serve(m, rng.vector(m.num_cols), clock)
            log(f"[{name}] {rec}, plan+measure {time.time()-t0:.0f}s")
            out[name] = {"nnz": int(m.nnz), "rows": m.num_rows,
                         "mtx_write_s": round(t_w, 1),
                         "mtx_read_s": round(t_r, 1),
                         "roundtrip_exact": bool(same), **rec}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpu_spmv_torch.benchmarks.mtx_bench")
    p.add_argument("--device", default="cuda",
                   help="where to run: the card (default), or cpu")
    p.add_argument("--out", default=None,
                   help="also write the JSON to this file")
    args = p.parse_args(argv)
    out = run(Clock.on(target_device(args.device, "mtx_bench")))
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    recs = [v for v in out.values() if isinstance(v, dict)]
    return 0 if all(r["correct"] and r["roundtrip_exact"] for r in recs) \
        else 1


if __name__ == "__main__":
    sys.exit(main())
