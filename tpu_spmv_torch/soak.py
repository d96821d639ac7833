"""Differential soak: every dispatch path of the port against the CPU oracle
(port of ``benchmarks/soak.py``).

    python -m tpu_spmv_torch.soak [--trials N] [--seed S] [--cpu]

Each trial draws a matrix from one of seven structure classes (uniform,
power-law, web graph, banded, hub, clustered, scrambled banded; 1-20,000
rows, 1-30,000 columns), in the JAX soak's order of draws, so one seed gives
the same matrices in both packages, and runs it through the public entry
points, each output held to :func:`~tpu_spmv_torch.utils.testing.spmv_matches`:

* ``spmv_csr`` with SCALAR_CSR, VECTOR_CSR and MERGE_PATH, row leveling on
  in half the trials (``TPU_SPMV_PERMUTE_ROWS``, set before the trial's
  first dispatch and restored at the end), at rel 1e-4;
* the pattern path on a column-scaled twin of the structure, at rel 1e-4;
* a bf16 value stream, at rel 8e-3 (the value rounding);
* ``reorder=True`` on square matrices of at least 4,096 rows and 2^16 nnz;
* ``spmv_ell`` where the longest row has at most 64 entries and rows × that
  length is under 2M;
* on every 5th trial (from the first), the sharded paths, which the JAX
  soak names but does not run: ``spmv_csr_sharded`` (flat) and
  ``spmv_csr_sharded_packed`` over a 4-shard local mesh, all shards on the
  one card (on the CPU with ``--cpu``).  A matrix whose shards the packed
  layout rejects (``WindowEllOverflow``) runs the flat path only.

It runs on the card unless ``--cpu`` is given; without a CUDA device and
without ``--cpu`` it exits 2.  Each failing path prints a ``FAIL`` line
with the JAX soak's fields; the last line sums up trials, paths run,
failures and seconds.  The exit code is 1 on any failure.

The module also carries ``tests/test_fuzz.py``'s structure generator
(:func:`fuzz_matrix`) and one planner case per lever group of that fuzz
slice (:func:`lever_case`), for the tests and the smoke run on the card.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np

from .csr import CSRMatrix
from .ell import ELLMatrix
from .errors import SpMVException
from .kernels import plan as tplan
from .kernels.plan import WindowEllOverflow
from .parallel import (make_row_mesh, shard_csr, shard_csr_packed,
                       spmv_csr_sharded, spmv_csr_sharded_packed)
from .spmv import KernelType, SpMVConfig, spmv_csr, spmv_ell
from .utils.testing import (RandomGenerator, clustered_csr,
                            scrambled_banded_csr, spmv_matches,
                            web_graph_csr)

KINDS = ("uniform", "powerlaw", "web", "banded", "hub", "clustered",
         "scrambled")
SHARDS = 4
SHARD_EVERY = 5
REL_TOL = 1e-4
BF16_TOL = 8e-3


def fuzz_matrix(rng: np.random.Generator, kind: int, rows: int,
                cols: int) -> CSRMatrix:
    """``tests/test_fuzz.py``'s adversarial structures (``_matrix``, the
    same draws): 0 a uniform random block, 1 a dense hub row, 2 a dense hub
    column, 3 a diagonal band, 4 a concentrated chunk in one row."""
    m = np.zeros((rows, cols), np.float32)
    if kind == 0:
        rr, cc = min(rows, 200), min(cols, 200)
        m[:rr, :cc] = (rng.random((rr, cc)) < 0.1) * rng.uniform(-5, 5)
    elif kind == 1:
        m[rng.integers(0, rows), :] = rng.uniform(-1, 1, cols)
    elif kind == 2:
        m[:, rng.integers(0, cols)] = rng.uniform(-1, 1, rows)
    elif kind == 3:
        for i in range(rows):
            j = int(i * cols / max(rows, 1))
            for dj in (-1, 0, 1):
                if 0 <= j + dj < cols:
                    m[i, j + dj] = 1.0 + i * 0.001
    else:
        c0 = int(rng.integers(0, max(cols - 100, 1)))
        m[rng.integers(0, rows), c0:c0 + min(100, cols - c0)] = 2.0
    return CSRMatrix.from_dense(m)


def make_matrix(r: np.random.Generator, kind: str, rows: int,
                cols: int) -> CSRMatrix:
    """One soak matrix of class ``kind`` (``benchmarks/soak.py:21-85``, the
    same draws); the square classes take at least 256 rows and may round
    them up to whole 128-blocks."""
    rng = RandomGenerator(int(r.integers(0, 2**31)))
    if kind == "uniform":
        k = int(r.integers(1, 32))
        ca = np.sort(r.integers(0, cols, (rows, k), dtype=np.int32), axis=1)
        va = r.random((rows, k)).astype(np.float32)
        rp = np.arange(rows + 1, dtype=np.int32) * k
        return CSRMatrix(rows, cols, va.reshape(-1), ca.reshape(-1), rp)
    if kind == "powerlaw":
        return rng.power_law_csr(rows, cols, avg_nnz=float(r.uniform(2, 40)),
                                 alpha=float(r.uniform(1.2, 2.5)))
    if kind == "web":
        return web_graph_csr(rng, rows, cols,
                             avg_nnz=float(r.uniform(4, 20)))
    if kind == "clustered":
        n = max(rows, 256)
        return clustered_csr(rng, n, n_clusters=int(r.integers(2, 17)),
                             avg_nnz=float(r.uniform(4, 16)))
    if kind == "scrambled":
        n = max(rows, 256)
        return scrambled_banded_csr(
            rng, n, bandwidth=int(r.integers(128, max(n // 2, 129))),
            avg_nnz=float(r.uniform(3, 12)))
    if kind == "banded":
        band = int(r.integers(1, 9))
        rr, cc, vv = [], [], []
        for d in range(-band, band + 1):
            i = np.arange(rows)
            j = (i * cols) // max(rows, 1) + d
            m = (j >= 0) & (j < cols)
            rr.append(i[m])
            cc.append(j[m])
            vv.append(r.random(int(m.sum())).astype(np.float32))
        rr, cc, vv = map(np.concatenate, (rr, cc, vv))
        o = np.lexsort((cc, rr))
        rp = np.zeros(rows + 1, np.int32)
        np.cumsum(np.bincount(rr, minlength=rows), out=rp[1:])
        return CSRMatrix(rows, cols, vv[o], cc[o].astype(np.int32), rp)
    # "hub": one dense row, one dense column and a sparse background
    bg = rng.power_law_csr(rows, cols, avg_nnz=2.0)
    hub_r = int(r.integers(0, rows))
    hub_c = int(r.integers(0, cols))
    rr = np.concatenate([np.full(cols, hub_r), np.arange(rows),
                         np.repeat(np.arange(rows), np.diff(bg.row_ptrs))])
    cc = np.concatenate([np.arange(cols), np.full(rows, hub_c),
                         bg.col_indices]).astype(np.int64)
    vv = np.concatenate([r.random(cols), r.random(rows),
                         bg.values]).astype(np.float32)
    key, idx = np.unique(rr.astype(np.int64) * cols + cc,
                         return_index=True)
    rr2 = (key // cols).astype(np.int64)
    rp = np.zeros(rows + 1, np.int32)
    np.cumsum(np.bincount(rr2, minlength=rows), out=rp[1:])
    return CSRMatrix(rows, cols, vv[idx], (key % cols).astype(np.int32), rp)


@contextlib.contextmanager
def env(**settings):
    """Set environment variables (``None`` unsets) for the block's
    duration, then restore what was there."""
    saved = {k: os.environ.get(k) for k in settings}
    try:
        for k, v in settings.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# one planner case per lever group of tests/test_fuzz.py: the structure
# (fuzz_matrix's kind, rows, cols), the environment the planner reads, and
# the planner's arguments ("banded": build_banded's)
LEVER_CASES = {
    "t_base": ((0, 4100, 2300), {},
               dict(split_rows=32, spill_rounds=2, cap_margin=0.45, sup=4096,
                    permute_rows=True, t_base=2)),
    "pattern": ((1, 2600, 3100), {},
                dict(split_rows=128, spill_rounds=3, cap_margin=0.2,
                     sup=1024, permute_rows=True, pattern=True, t_base=4)),
    "step_width": ((1, 5200, 3900), {},
                   dict(split_rows=128, step_groups=128)),
    "spill_beta": ((2, 3300, 2050),
                   {"TPU_SPMV_BALANCE_WINDOW": 4, "TPU_SPMV_BALANCE_LAYER": 2},
                   dict(split_rows=128, spill_beta=1.5, cap_slack=0,
                        spill_rounds=2)),
    "bypass_l2": ((1, 4700, 3300),
                  {"TPU_SPMV_BYPASS_K": 3, "TPU_SPMV_L2_BALANCE": 1},
                  dict(split_rows=32, permute_rows=True)),
    "nonstandard_step": ((3, 3900, 2700), {},
                         dict(split_rows=128, step_groups=40)),
    "banded": ((0, 7000, 3500), {},
               dict(sup=1024, n_bands=3, spill_beta=2.2, cap_slack=1)),
    "bf16": ((2, 3600, 2900), {},
             dict(split_rows=128, sup=1024, permute_rows=True,
                  values_dtype="bfloat16")),
}


def lever_case(name: str, seed: int = 0) -> tuple:
    """``(A, x, host plan)`` for the lever group ``name`` of
    :data:`LEVER_CASES`: ``A`` the oracle's matrix (all ones for a pattern
    plan), ``x`` from the same seed, the plan a ``HostPlan`` (a
    ``HostBanded`` for ``"banded"``) built under the case's environment."""
    (kind, rows, cols), settings, kw = LEVER_CASES[name]
    r = np.random.default_rng(seed)
    A = fuzz_matrix(r, kind, rows, cols)
    x = r.uniform(-3, 3, cols).astype(np.float32)
    with env(**settings):
        if name == "banded":
            hp = tplan.build_banded(A, **kw)
        else:
            hp = tplan.build(A, **kw)
    if kw.get("pattern"):
        A = CSRMatrix(A.num_rows, A.num_cols, np.ones(A.nnz, np.float32),
                      A.col_indices, A.row_ptrs)
    return A, x, hp


def _y(res) -> np.ndarray | None:
    return res.y_host() if res.error_code == 0 else None


def run(trials: int, seed: int, device: str) -> tuple:
    """The soak: ``(paths run, failures)``; prints a ``FAIL`` line per
    failing path and a progress line every 10 trials."""
    r = np.random.default_rng(seed)
    mesh = make_row_mesh(SHARDS, devices=["cpu" if device == "cpu"
                                          else "cuda:0"] * SHARDS)
    t0 = time.time()
    paths = fails = 0

    def check(ok: bool, line: str) -> None:
        nonlocal paths, fails
        paths += 1
        if not ok:
            fails += 1
            print("FAIL" + line, flush=True)

    def matches(y, csr, x, tol) -> bool:
        return y is not None and spmv_matches(y, csr, x, rel_tol=tol)

    with env(TPU_SPMV_PERMUTE_ROWS=None):
        for trial in range(trials):
            kind = KINDS[int(r.integers(0, len(KINDS)))]
            rows = int(r.integers(1, 20000))
            cols = int(r.integers(1, 30000))
            csr = make_matrix(r, kind, rows, cols)
            rows, cols = csr.num_rows, csr.num_cols
            x = r.uniform(-2, 2, cols).astype(np.float32)
            perm = bool(r.integers(0, 2))
            os.environ["TPU_SPMV_PERMUTE_ROWS"] = "1" if perm else "0"
            where = f"trial={trial} kind={kind} {rows}x{cols}"
            for kt in (KernelType.SCALAR_CSR, KernelType.VECTOR_CSR,
                       KernelType.MERGE_PATH):
                res = spmv_csr(csr, x, SpMVConfig(kernel_type=kt),
                               device=device)
                check(matches(_y(res), csr, x, REL_TOL),
                      f" {where} nnz={csr.nnz} kernel={kt.name} "
                      f"perm={perm} err={res.error_code}")
            s = r.uniform(0.5, 2.0, cols).astype(np.float32)
            pat = CSRMatrix(rows, cols, s[csr.col_indices], csr.col_indices,
                            csr.row_ptrs)
            res = spmv_csr(pat, x, SpMVConfig(
                kernel_type=KernelType.MERGE_PATH, pattern=True),
                device=device)
            check(matches(_y(res), pat, x, REL_TOL),
                  f"(pattern) {where} err={res.error_code}")
            res = spmv_csr(csr, x, SpMVConfig(
                kernel_type=KernelType.MERGE_PATH, bf16_values=True),
                device=device)
            check(matches(_y(res), csr, x, BF16_TOL),
                  f"(bf16) {where} err={res.error_code}")
            if rows == cols and rows >= 4096 and csr.nnz >= (1 << 16):
                res = spmv_csr(csr, x, SpMVConfig(
                    kernel_type=KernelType.VECTOR_CSR, reorder=True),
                    device=device)
                check(matches(_y(res), csr, x, REL_TOL),
                      f"(reorder) {where} err={res.error_code}")
            longest = csr.compute_stats().max_nnz_per_row
            if csr.nnz and longest <= 64 and rows * longest < 2_000_000:
                res = spmv_ell(ELLMatrix.from_csr(csr), x, device=device)
                check(matches(_y(res), csr, x, REL_TOL), f"(ELL) {where}")
            if trial % SHARD_EVERY == 0:
                for label, shard, spmv in (
                        ("flat", shard_csr, spmv_csr_sharded),
                        ("packed", shard_csr_packed, spmv_csr_sharded_packed)):
                    err = ""
                    try:
                        y = spmv(shard(csr, mesh), x).cpu().numpy()
                    except WindowEllOverflow:
                        continue    # a shard the packed layout rejects
                    except SpMVException as e:
                        y, err = None, f" err={int(e.code)}"
                    check(matches(y, csr, x, REL_TOL),
                          f"(sharded {label}) {where}{err}")
            if trial % 10 == 9:
                print(f"  {trial + 1}/{trials} trials, {fails} failures, "
                      f"{time.time() - t0:.0f}s", flush=True)
    return paths, fails


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpu_spmv_torch.soak",
        description="Every dispatch path of the port against the CPU "
                    "oracle on randomized matrices.")
    p.add_argument("--trials", type=int, default=60)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions); "
                        "the default is the card")
    args = p.parse_args(argv)
    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("soak: no CUDA device is available; pass --cpu to run the "
              "kernels' plain versions on the CPU", file=sys.stderr)
        return 2
    device = "cpu" if args.cpu else "cuda"
    t0 = time.time()
    paths, fails = run(args.trials, args.seed, device)
    print(f"soak: {args.trials} trials, {paths} paths, {fails} failures, "
          f"{time.time() - t0:.1f}s on {device}", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
