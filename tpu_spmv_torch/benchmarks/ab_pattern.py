"""Pattern plans (no value stream) against value plans, on the device
(port of ``benchmarks/ab_pattern.py``).

    python3 -m tpu_spmv_torch.benchmarks.ab_pattern [--device cpu]

1. The headline's structure as a natural plan, a pattern plan and a
   leveled pattern plan at step width 128, each held to the CPU oracle (the
   pattern plans to the unit-valued matrix) and timed (300 calls, median of
   5) under the physics guard.
2. PageRank (50 iterations at most, the default tolerance) on a 262,144-node
   column-normalised random graph (``np.random.default_rng(7)``, 14 edges a
   node, no self loops), through the generic packed path
   (``TPU_SPMV_NO_PATTERN=1``) and the pattern path: wall ms a run after a
   warm-up run, host set-up included, the device synchronised.

The last line is one JSON object, ``device`` and the rows.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..bench import check
from ..csr import CSRMatrix
from ..errors import guarded_upload
from ..kernels.plan import build
from ..kernels.window_ell import plan_from_host, spmv_window_ell
from ..pagerank import PageRankConfig, pagerank
from ..soak import env
from ..utils.testing import RandomGenerator
from . import checked_seconds, device_main

ITERS = 300
PLANS = (("natural S=128", {}),
         ("pattern S=128", {"pattern": True}),
         ("pattern+perm S=128", {"pattern": True, "permute_rows": True}))


def plans_leg(csr: CSRMatrix, x: np.ndarray, clock,
              iters: int = ITERS) -> list:
    unit = CSRMatrix(csr.num_rows, csr.num_cols,
                     np.ones(csr.nnz, np.float32), csr.col_indices,
                     csr.row_ptrs)
    xd = guarded_upload(x, clock.device)
    rows = []
    for label, kw in PLANS:
        t0 = time.time()
        p = plan_from_host(build(csr, split_rows=128, step_groups=128, **kw),
                           clock.device)
        build_s = time.time() - t0
        s = checked_seconds(label, lambda: spmv_window_ell(p, xd),
                            unit if kw.get("pattern") else csr, x,
                            p.stream_bytes, clock, iters)
        rows.append({"label": label, "groups": p.n_groups,
                     "stream_mb": p.stream_bytes / 1e6,
                     "build_s": round(build_s, 2), "t_us": s * 1e6,
                     "correct": True})
        print(f"{label}: groups={p.n_groups} stream="
              f"{p.stream_bytes/1e6:.0f}MB build={build_s:.0f}s ok=True "
              f"t={s*1e6:.1f} us", flush=True)
    return rows


def random_transition(n: int, per_node: int = 14, seed: int = 7):
    """The JAX script's column-normalised random graph."""
    g = np.random.default_rng(seed)
    m = n * per_node
    rows_a = g.integers(0, n, m)
    cols_a = g.integers(0, n, m)
    keep = rows_a != cols_a
    rows_a, cols_a = rows_a[keep], cols_a[keep]
    outdeg = np.bincount(cols_a, minlength=n)
    vals = (1.0 / np.maximum(outdeg, 1)[cols_a]).astype(np.float32)
    order = np.lexsort((cols_a, rows_a))
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows_a, minlength=n), out=ptr[1:])
    return CSRMatrix(n, n, vals[order], cols_a[order].astype(np.int32),
                     ptr.astype(np.int32))


def pagerank_leg(A: CSRMatrix, device: torch.device,
                 max_iterations: int = 50) -> list:
    cfg = PageRankConfig(max_iterations=max_iterations)
    rows, ranks = [], {}
    for label, no_pattern in (("pagerank generic", "1"),
                              ("pagerank pattern", None)):
        with env(TPU_SPMV_NO_PATTERN=no_pattern):
            pagerank(A, cfg, device=device)             # plans, uploads
            t0 = time.perf_counter()
            r = pagerank(A, cfg, device=device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
        check(r.error_code == 0, f"{label}: error code {r.error_code}")
        ranks[label] = r.ranks.cpu().numpy()
        rows.append({"label": label, "plan": type(r.plan).__name__,
                     "iterations": r.iterations, "converged": r.converged,
                     "residual": r.final_residual, "wall_ms": wall * 1e3,
                     "ms_per_iter": wall * 1e3 / max(r.iterations, 1)})
        print(f"{label} ({type(r.plan).__name__}): iters={r.iterations} "
              f"conv={r.converged} res={r.final_residual:.2e} "
              f"wall={wall*1e3:.1f} ms (~{rows[-1]['ms_per_iter']:.3f} "
              "ms/iter incl. host)", flush=True)
    a, b = ranks.values()
    ok = bool(np.allclose(a, b, rtol=1e-4, atol=1e-7))
    check(ok, "the two PageRank paths' ranks differ")
    for row in rows:
        row["correct"] = ok
    return rows


def run(clock, args) -> list:
    rng = RandomGenerator(42)
    csr = rng.power_law_csr(262144, 4096, avg_nnz=40.0, alpha=1.6)
    rows = plans_leg(csr, rng.vector(4096), clock)
    return rows + pagerank_leg(random_transition(262144), clock.device)


def main(argv=None) -> int:
    return device_main(argparse.ArgumentParser(
        prog="tpu_spmv_torch.benchmarks.ab_pattern"), argv, run)


if __name__ == "__main__":
    sys.exit(main())
