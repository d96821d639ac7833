"""Test utilities (port of ``tpu_spmv/utils/testing.py``).

The generators make the same NumPy draws in the same order as the JAX
package's, so one seed gives the identical matrix in both packages.
"""

from __future__ import annotations

import numpy as np

DEFAULT_SEED = 42


class RandomGenerator:
    """Seeded RNG (reference mt19937 with seed 42, ``test_utils.h:12-32``)."""

    def __init__(self, seed: int = DEFAULT_SEED):
        self.rng = np.random.Generator(np.random.MT19937(seed))

    def uniform(self, lo: float, hi: float) -> float:
        return float(self.rng.uniform(lo, hi))

    def uniform_int(self, lo: int, hi: int) -> int:
        """Inclusive range, like std::uniform_int_distribution."""
        return int(self.rng.integers(lo, hi + 1))

    def dense_matrix(self, rows: int, cols: int, density: float = 0.1,
                     lo: float = -10.0, hi: float = 10.0) -> np.ndarray:
        """Random dense matrix with ~density fraction of non-zeros
        (reference ``generateRandomDenseMatrix``)."""
        keep = self.rng.random((rows, cols)) < density
        vals = self.rng.uniform(lo, hi, (rows, cols)).astype(np.float32)
        return np.where(keep, vals, np.float32(0.0)).astype(np.float32)

    def vector(self, n: int, lo: float = -10.0,
               hi: float = 10.0) -> np.ndarray:
        """Random f32 vector (reference ``generateRandomVector``)."""
        return self.rng.uniform(lo, hi, n).astype(np.float32)

    def csr(self, rows: int, cols: int, density: float = 0.1):
        """Random CSRMatrix via a dense round trip."""
        from ..csr import CSRMatrix

        return CSRMatrix.from_dense(self.dense_matrix(rows, cols, density))

    def power_law_csr(self, rows: int, cols: int, avg_nnz: float = 8.0,
                      alpha: float = 1.5):
        """Skewed (power-law row-length) CSRMatrix — the workload class the
        merge-path kernel targets."""
        from ..csr import CSRMatrix

        raw = self.rng.pareto(alpha, rows) + 1.0
        lens = np.minimum((raw * avg_nnz / raw.mean()).astype(np.int64), cols)
        row_ptrs = np.zeros(rows + 1, np.int32)
        np.cumsum(lens, out=row_ptrs[1:])
        nnz = int(row_ptrs[-1])
        cols_arr = np.empty(nnz, np.int32)
        for i in range(rows):  # sorted unique columns per row
            k = int(lens[i])
            if k:
                cols_arr[row_ptrs[i]:row_ptrs[i + 1]] = np.sort(
                    self.rng.choice(cols, size=k, replace=False)
                )
        vals = self.rng.uniform(-10, 10, nnz).astype(np.float32)
        vals[vals == 0.0] = 1.0
        return CSRMatrix(rows, cols, vals, cols_arr, row_ptrs)


def abs_row_scale(csr, x) -> np.ndarray:
    """``(|A| |x|)_i`` per row: the magnitude that bounds the rounding error
    of any summation order of row ``i``."""
    scale = np.zeros(csr.num_rows, np.float32)
    if csr.nnz:
        mags = np.abs(csr.values) \
            * np.abs(np.asarray(x, np.float32))[csr.col_indices]
        row_ids = np.repeat(np.arange(csr.num_rows), np.diff(csr.row_ptrs))
        np.add.at(scale, row_ids, mags)
    return scale


def spmv_matches(y_dev, csr, x, rel_tol: float = 1e-6) -> bool:
    """Device-vs-oracle comparison with the backward-error bound for
    reordered summation: per element, either the plain relative test of
    :func:`spmv_rel_equal` holds for the whole vector, or
    ``|y - ŷ|_i <= rel_tol * max((|A| |x|)_i, 1)``."""
    from ..ops.cpu_reference import spmv_cpu_csr

    y_dev = np.asarray(y_dev, np.float32)
    y_ref = np.zeros(csr.num_rows, np.float32)
    spmv_cpu_csr(csr, x, y_ref)
    if y_dev.shape != y_ref.shape:
        return False
    diff = np.abs(y_dev - y_ref)
    plain = spmv_rel_equal(y_dev, y_ref, rel_tol)
    return bool(plain or np.all(
        diff <= rel_tol * np.maximum(abs_row_scale(csr, x), 1.0)))


def spmv_rel_equal(gpu, cpu, rel_tol: float = 1e-6) -> bool:
    """Relative tolerance with an absolute floor when both magnitudes are
    below 1e-10 (reference ``test_spmv.cu:18-35``)."""
    gpu = np.asarray(gpu, np.float32)
    cpu = np.asarray(cpu, np.float32)
    if gpu.shape != cpu.shape:
        return False
    both_tiny = (np.abs(gpu) < 1e-10) & (np.abs(cpu) < 1e-10)
    diff = np.abs(gpu - cpu)
    denom = np.maximum(np.abs(cpu), 1e-30)
    ok = both_tiny | (diff <= 1e-6) | (diff / denom <= rel_tol)
    return bool(np.all(ok))
